from .flash_attention import flash_attention
from .ops import FlashAttention, FlashAttentionBackward, gqa_flash_attention
from .ref import attention_ref, gqa_attention_bwd_ref, gqa_attention_ref

__all__ = ["FlashAttention", "FlashAttentionBackward", "attention_ref",
           "flash_attention", "gqa_attention_bwd_ref", "gqa_attention_ref",
           "gqa_flash_attention"]
