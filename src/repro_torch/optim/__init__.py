from .optimizers import (OptState, Optimizer, adam, adamw, apply_updates,
                         clip_by_global_norm, get_optimizer, global_norm,
                         momentum, sgd)
from .schedules import constant, cosine, get_schedule, warmup_cosine

__all__ = ["OptState", "Optimizer", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "constant", "cosine", "get_optimizer",
           "get_schedule", "global_norm", "momentum", "sgd", "warmup_cosine"]
