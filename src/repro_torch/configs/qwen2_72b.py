"""qwen2-72b [dense] — GQA kv=8, QKV bias. [arXiv:2407.10671]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    arch_type="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    activation="silu_glu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)
