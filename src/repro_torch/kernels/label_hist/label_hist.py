"""Per-client label histograms: the wrapper of ``csrc/label_hist.cu``.

Replaces src/repro/kernels/label_hist/label_hist.py:label_hist_kernel.  The
source note in the .cu file says what bounds the kernel on the card and how its
design differs from the TPU kernel's sequential sample grid.
"""
from __future__ import annotations

import torch

from ..build import check_launch, library
from .ref import label_hist_ref

# Shared memory the kernel's int32 bins may take without an opt-in attribute.
_MAX_CLASSES = 48 * 1024 // 4

# Launches of the CUDA kernel since the last reset (repro_torch.kernels).
launches = 0


def label_hist_kernel(labels: torch.Tensor, valid: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """labels (B, n) int32, valid (B, n) bool -> (B, C) float32 counts.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one block per client row) or raises."""
    if labels.dim() != 2 or valid.shape != labels.shape:
        raise ValueError(f"need labels and valid of one (B, n) shape; got "
                         f"{tuple(labels.shape)} and {tuple(valid.shape)}")
    if labels.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"need int32 labels and bool valid; got {labels.dtype} "
                        f"and {valid.dtype}")
    if labels.device.type == "cpu" and valid.device.type == "cpu":
        return label_hist_ref(labels, valid, num_classes)
    if labels.device.type != "cuda" or valid.device != labels.device:
        raise ValueError(f"label_hist_kernel runs on one CUDA device; got "
                         f"{labels.device} and {valid.device}")
    if not (labels.is_contiguous() and valid.is_contiguous()):
        raise ValueError("label_hist_kernel needs contiguous inputs")
    if not 0 < num_classes <= _MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {_MAX_CLASSES}]; "
                         f"got {num_classes}")
    rows, n = labels.shape
    out = torch.empty((rows, num_classes), dtype=torch.float32,
                      device=labels.device)
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(labels.device).cuda_stream
    check_launch("label_hist", library().repro_label_hist(
        labels.data_ptr(), valid.data_ptr(), out.data_ptr(), rows, n,
        num_classes, stream))
    global launches
    launches += 1
    return out
