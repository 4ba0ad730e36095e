from .cnn import cnn_apply, cnn_init, cnn_loss

__all__ = ["cnn_apply", "cnn_init", "cnn_loss"]
