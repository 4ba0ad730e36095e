"""whisper-tiny [audio] — enc-dec transformer; mel+conv frontend is a STUB
(input_specs supplies precomputed frame embeddings). [arXiv:2212.04356]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,              # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    activation="gelu_glu",
    is_encoder_decoder=True,
    encoder_layers=4,
    num_frames=1500,
    scan_layers=False,
    fsdp=False,
    remat=False,
    source="arXiv:2212.04356",
)
