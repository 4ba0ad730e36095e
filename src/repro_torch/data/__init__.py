from .fl_data import client_batches, materialize_round, round_histograms
from .specs import batch_specs, decode_specs, input_specs, text_len
from .synthetic import ImageDataset, TokenDataset, modality_inputs

__all__ = ["ImageDataset", "TokenDataset", "batch_specs", "client_batches",
           "decode_specs", "input_specs", "materialize_round",
           "modality_inputs",
           "round_histograms", "text_len"]
