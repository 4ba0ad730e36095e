"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                    # mamba blocks carry no separate FFN
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,              # d_inner = 4096
    ssm_head_dim=64,           # 64 SSD heads
    ssm_groups=1,
    ssm_conv_width=4,
    ssm_chunk=128,
    source="arXiv:2405.21060",
)
