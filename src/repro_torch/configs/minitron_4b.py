"""minitron-4b [dense] — pruned nemotron (GQA kv=8, squared-ReLU).
[arXiv:2407.14679]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    activation="relu2",        # nemotron family
    source="arXiv:2407.14679",
)
