"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    activation="silu_glu",
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=14336,
    moe_layer_period=2,        # MoE every other block
    attn_layer_period=8,       # 1 attention block per 8 (1:7)
    attn_layer_offset=4,
    ssm_state=16,              # jamba uses mamba d_state=16
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv_width=4,
    ssm_chunk=128,
    source="arXiv:2403.19887",
)
