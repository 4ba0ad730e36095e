"""arctic-480b [moe] — 128 experts top-2 MoE in parallel with a dense residual
FFN every layer (dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    activation="silu_glu",
    num_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual_d_ff=4864,   # parallel dense FFN residual
    moe_layer_period=1,
    source="hf:Snowflake/snowflake-arctic-base",
)
