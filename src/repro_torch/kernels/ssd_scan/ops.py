"""The model-layer SSD signature, (b, S, H, P) with per-head A and grouped
B/C, in front of the SSD scan kernel.

Replaces src/repro/kernels/ssd_scan/ops.py:ssd_apply, which matches
``repro.models.layers._ssd_chunked``.  The reference repeats B/C per head and
tiles A over the batch before flattening (b, H) into rows, so row ``bh``
uses head ``bh % H``, group ``(bh % H) // (H / G)`` and ``A[bh % H]``; the
kernel reads the same group and head in place, without the copies.
"""
from __future__ import annotations

import torch

from .ref import ssd_apply_ref
from .ssd_scan import _on_cpu, launch


def ssd_apply(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, chunk: int = 128):
    """x (b, S, H, P); dt (b, S, H); A (H,); B/C (b, S, G, N) with G dividing
    H.  Returns (y (b, S, H, P), final_state (b, H, P, N)), float32.
    S % chunk == 0, as the reference requires.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    b, s, h, p = x.shape
    g = B.shape[2]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.dim() != 4 \
            or B.shape[:2] != (b, s) or C.shape != B.shape or g == 0 or h % g:
        raise ValueError(f"need x (b, S, H, P), dt (b, S, H), A (H,), B/C "
                         f"(b, S, G, N) with G dividing H; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    if _on_cpu(x, dt, A, B, C):
        return ssd_apply_ref(x, dt, A, B, C)
    return launch(*(t.float().contiguous() for t in (x, dt, A, B, C)),
                  a_stride=0)
