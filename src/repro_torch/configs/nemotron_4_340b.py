"""nemotron-4-340b [dense] — GQA kv=8, squared-ReLU MLP. [arXiv:2402.16819]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,              # 18432 / 96
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",        # squared-ReLU, non-gated
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
)
