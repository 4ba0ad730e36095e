from .checkpoint import (latest_checkpoint, load_checkpoint, read_checkpoint,
                         save_checkpoint)

__all__ = ["latest_checkpoint", "load_checkpoint", "read_checkpoint",
           "save_checkpoint"]
