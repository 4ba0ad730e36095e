from .fl_data import client_batches, materialize_round, round_histograms
from .synthetic import ImageDataset, TokenDataset

__all__ = ["ImageDataset", "TokenDataset", "client_batches",
           "materialize_round", "round_histograms"]
