"""The model-layer attention signature, (B, S, H, D) x (B, S, KV, D) with
grouped-query heads, in front of the flash-attention kernel.

Replaces src/repro/kernels/flash_attention/ops.py:gqa_flash_attention.  The
reference repeats K/V per q-head before flattening; the kernel reads kv-head
``h // (H // KV)`` directly, which is the same mapping without the copy.
"""
from __future__ import annotations

import torch

from .flash_attention import _on_cpu, launch
from .ref import gqa_attention_ref


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, S, KV, D) with KV dividing H -> (B, S, H, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"need q (B, S, H, D) and k/v (B, S, KV, D) with KV "
                         f"dividing H; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if _on_cpu(q, k, v):
        return gqa_attention_ref(q, k, v, causal, window)
    return launch(q, k, v, causal=causal, window=window)
