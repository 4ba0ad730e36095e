from .optimizers import (OptState, Optimizer, adam, apply_updates,
                         get_optimizer, sgd)

__all__ = ["OptState", "Optimizer", "adam", "apply_updates", "get_optimizer",
           "sgd"]
