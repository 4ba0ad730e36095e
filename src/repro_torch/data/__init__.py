from .fl_data import client_batches, materialize_round
from .synthetic import ImageDataset

__all__ = ["ImageDataset", "client_batches", "materialize_round"]
