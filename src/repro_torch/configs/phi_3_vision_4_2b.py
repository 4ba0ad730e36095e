"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,          # GQA kv=32 (MHA)
    d_ff=8192,
    vocab_size=32064,
    activation="silu_glu",
    num_patch_tokens=1024,     # stub ViT/CLIP patch embeddings
    vision_embed_dim=1024,     # CLIP-L hidden size, pre-projector
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
