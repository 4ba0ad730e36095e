"""The model-layer SSD signature, (b, S, H, P) with per-head A and grouped
B/C, in front of the SSD scan kernel, differentiable.

Replaces src/repro/kernels/ssd_scan/ops.py:ssd_apply, which matches
``repro.models.layers._ssd_chunked``.  The reference repeats B/C per head and
tiles A over the batch before flattening (b, H) into rows, so row ``bh``
uses head ``bh % H``, group ``(bh % H) // (H / G)`` and ``A[bh % H]``; the
kernel reads the same group and head in place, without the copies.

``SSDScan`` is a ``torch.autograd.Function`` (``setup_context`` style): its
forward is the ``repro_torch::ssd_scan`` op, the kernel on a CUDA tensor
(the plain recurrence on a CPU tensor), and that output is the one the
model uses.  Its backward is
``torch.func.vjp`` of the plain chunked form ``ref.ssd_chunked_ref``, the
function the reference itself differentiates for training
(``repro/models/layers.py:_ssd_chunked``, computed there outside any Pallas
kernel): the one place where training on the card runs plain PyTorch, O(S ·
chunk) rather than the step loop.  A hand-written backward is open work
(ROADMAP.md Queue 2 item 4).  Its ``vmap`` rule folds the mapped dimension
into b, so a ``vmap`` over clients makes one kernel launch.
"""
from __future__ import annotations

import torch

from ..flash_attention.ops import fold, unfold
from .ref import ssd_chunked_ref
from .ssd_scan import ssd_scan_op

# Backward calls (plain vjps, no kernel) since the last reset; read beside
# the kernels' launch counts.
vjp_calls = 0


class SSDScan(torch.autograd.Function):
    """(y, final_state) of x (b, S, H, P), dt (b, S, H), A (b, H) (a row of
    per-head rates a batch entry), B/C (b, S, G, N); ``chunk`` is the
    reference's chunk length, which the backward's chunked form takes."""

    @staticmethod
    def forward(x, dt, A, B, C, chunk: int):
        return ssd_scan_op(x, dt, A, B, C)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])
        ctx.chunk = inputs[5]

    @staticmethod
    def backward(ctx, gy, gfin):
        global vjp_calls
        vjp_calls += 1
        chunk = ctx.chunk
        _, vjp = torch.func.vjp(
            lambda *a: ssd_chunked_ref(*a, chunk), *ctx.saved_tensors)
        return (*vjp((gy, gfin)), None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, B, C, chunk):
        n = info.batch_size
        args = fold((x, dt, A, B, C), in_dims[:5], n)
        y, fin = SSDScan.apply(*args, chunk)
        return (unfold(y, n), unfold(fin, n)), (0, 0)


def ssd_apply(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, chunk: int = 128):
    """x (b, S, H, P); dt (b, S, H); A (H,); B/C (b, S, G, N) with G dividing
    H.  Returns (y (b, S, H, P), final_state (b, H, P, N)), float32,
    differentiable in every input.  S % chunk == 0, as the reference
    requires.

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
    return SSDScan.apply(x, dt, A.expand(b, h), B, C, chunk)
