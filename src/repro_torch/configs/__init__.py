from .paper_cnn import CONFIG, FL, FLConfig, PaperCNNConfig

__all__ = ["CONFIG", "FL", "FLConfig", "PaperCNNConfig"]
