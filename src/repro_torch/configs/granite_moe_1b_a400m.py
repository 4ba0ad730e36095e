"""granite-moe-1b-a400m [moe] — 32 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    activation="silu_glu",
    num_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    moe_layer_period=1,
    fsdp=False,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
