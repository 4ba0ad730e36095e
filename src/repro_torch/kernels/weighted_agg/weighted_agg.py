"""Weighted sum over stacked client parameters: the wrapper of
``csrc/weighted_agg.cu``.

Replaces src/repro/kernels/weighted_agg/weighted_agg.py:weighted_agg_kernel.
The source note in the .cu file says what bounds the kernel on the card and
why it is a column reduction on CUDA cores rather than a tensor-core product.
"""
from __future__ import annotations

import torch

from ..build import check_launch, library
from .ref import weighted_agg_ref

_ENTRY = {torch.float32: "repro_weighted_agg_f32",
          torch.bfloat16: "repro_weighted_agg_bf16"}

# Launches of the CUDA kernel since the last reset (repro_torch.kernels).
launches = 0


def weighted_agg_kernel(stacked: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """stacked (K, N) float32 or bfloat16, scales (K,) float32 -> (N,)
    ``sum_k scales[k] * stacked[k]`` in ``stacked``'s dtype, accumulated in
    float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if stacked.dim() != 2 or scales.shape != stacked.shape[:1]:
        raise ValueError(f"need stacked (K, N) and scales (K,); got "
                         f"{tuple(stacked.shape)} and {tuple(scales.shape)}")
    if stacked.device.type == "cpu" and scales.device.type == "cpu":
        return weighted_agg_ref(stacked, scales)
    if stacked.device.type != "cuda" or scales.device != stacked.device:
        raise ValueError(f"weighted_agg_kernel runs on one CUDA device; got "
                         f"{stacked.device} and {scales.device}")
    if stacked.dtype not in _ENTRY or scales.dtype != torch.float32:
        raise TypeError(f"need float32 or bfloat16 stacked and float32 "
                        f"scales; got {stacked.dtype} and {scales.dtype}")
    if not (stacked.is_contiguous() and scales.is_contiguous()):
        raise ValueError("weighted_agg_kernel needs contiguous inputs")
    k, n = stacked.shape
    out = torch.empty((n,), dtype=stacked.dtype, device=stacked.device)
    if n == 0:
        return out
    entry = _ENTRY[stacked.dtype]
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    check_launch("weighted_agg", getattr(library(), entry)(
        stacked.data_ptr(), scales.data_ptr(), out.data_ptr(), k, n, stream))
    global launches
    launches += 1
    return out
