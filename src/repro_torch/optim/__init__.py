from .optimizers import (OptState, Optimizer, adam, adamw, apply_updates,
                         clip_by_global_norm, get_optimizer, global_norm, sgd)

__all__ = ["OptState", "Optimizer", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "get_optimizer", "global_norm", "sgd"]
