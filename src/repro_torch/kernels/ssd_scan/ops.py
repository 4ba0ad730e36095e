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
model uses.  Its backward, ``SSDScanBackward``, is the
``repro_torch::ssd_scan_bwd`` op: the backward kernels on a CUDA tensor (or
raise), and on a CPU tensor the plain backward, ``torch.func.vjp`` of the
chunked form ``ref.ssd_chunked_ref``, the function the reference itself
differentiates for training (``repro/models/layers.py:_ssd_chunked``,
outside any Pallas kernel).  Each has a ``vmap`` rule that folds the mapped
dimension into b, so a ``vmap`` over clients makes one kernel launch each
way, and ``vmap(grad(...))`` and ``grad(vmap(...))`` both work.  The
backward is not differentiable again.
"""
from __future__ import annotations

import torch

from ..flash_attention.ops import fold, unfold
from .backward import ssd_scan_bwd_op
from .ssd_scan import ssd_scan_op


class SSDScan(torch.autograd.Function):
    """(y, final_state) of x (b, S, H, P), dt (b, S, H), A (b, H) (a row of
    per-head rates a batch entry), B/C (b, S, G, N); ``chunk`` is the
    reference's chunk length, which the plain backward's chunked form
    takes."""

    @staticmethod
    def forward(x, dt, A, B, C, chunk: int):
        return ssd_scan_op(x, dt, A, B, C)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])
        ctx.chunk = inputs[5]

    @staticmethod
    def backward(ctx, gy, gfin):
        return (*SSDScanBackward.apply(*ctx.saved_tensors, gy, gfin,
                                       ctx.chunk), None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, B, C, chunk):
        n = info.batch_size
        args = fold((x, dt, A, B, C), in_dims[:5], n)
        y, fin = SSDScan.apply(*args, chunk)
        return (unfold(y, n), unfold(fin, n)), (0, 0)


class SSDScanBackward(torch.autograd.Function):
    """(dx, ddt, dA, dB, dC) of :class:`SSDScan` at (x, dt, A, B, C) for
    output gradients gy and gfin."""

    @staticmethod
    def forward(x, dt, A, B, C, gy, gfin, chunk: int):
        return ssd_scan_bwd_op(x, dt, A, B, C, gy, gfin, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the SSD scan's backward is not "
                                  "differentiable (no double backward)")

    @staticmethod
    def vmap(info, in_dims, x, dt, A, B, C, gy, gfin, chunk):
        n = info.batch_size
        args = fold((x, dt, A, B, C, gy, gfin), in_dims[:7], n)
        grads = SSDScanBackward.apply(*args, chunk)
        return tuple(unfold(g, n) for g in grads), (0,) * 5


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
