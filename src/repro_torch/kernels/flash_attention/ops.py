"""The model-layer attention signature, (B, S, H, D) x (B, S, KV, D) with
grouped-query heads, in front of the flash-attention kernels, forward and
backward.

Replaces src/repro/kernels/flash_attention/ops.py:gqa_flash_attention.  The
reference repeats K/V per q-head before flattening; the kernels read kv-head
``h // (H // KV)`` directly, which is the same mapping without the copy.

``FlashAttention`` is a ``torch.autograd.Function`` (``setup_context``
style) that returns the output and each row's logsumexp L, which it saves
for its backward, ``FlashAttentionBackward``, the backward kernels.  Each
is the one code path on both devices: its ``forward`` calls one
``repro_torch`` op (``flash_attention`` / ``flash_attention_bwd``), in which
a CPU tensor takes the plain version and a CUDA tensor the kernel (or
raises), and whose fake form lets a graph be traced through it.
Each has a ``vmap`` rule that folds the mapped dimension into B and calls
``apply`` once, so ``torch.func.vmap`` over clients or trials makes one
launch for all of them, and ``vmap(grad(...))`` and ``grad(vmap(...))``
both work.  The backward is not differentiable again.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .backward import flash_attention_bwd_op
from .flash_attention import flash_attention_op


def fold(xs: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
         n: int):
    """vmap's operands with their mapped dim ``dims[i]`` (None: unmapped,
    broadcast) moved to the front and merged into the leading (batch) dim:
    (…, B, …) -> (n·B, …)."""
    out = []
    for x, d in zip(xs, dims):
        x = x.expand((n,) + x.shape) if d is None else x.movedim(d, 0)
        out.append(x.reshape((n * x.shape[1],) + x.shape[2:]))
    return out


def unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n·B, …) -> (n, B, …)."""
    return x.reshape((n, x.shape[0] // n) + x.shape[1:])


class FlashAttention(torch.autograd.Function):
    """(o, lse) = attention(q, k, v); q (B, S, H, D), k/v (B, S, KV, D).
    With ``with_lse``, lse (B, H, S) float32 is each row's logsumexp of the
    scaled, masked scores, which the backward reads; without it (no
    gradient to come: serving, evaluation) the kernel writes none and lse is
    an empty (B, H, 0).  o is the same bits either way; lse is not
    differentiable."""

    @staticmethod
    def forward(q, k, v, causal: bool, window: int, with_lse: bool):
        return flash_attention_op(q, k, v, causal, window, with_lse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, _ = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBackward.apply(q, k, v, o, lse, do,
                                                  ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, with_lse):
        n = info.batch_size
        q, k, v = fold((q, k, v), in_dims[:3], n)
        o, lse = FlashAttention.apply(q, k, v, causal, window, with_lse)
        return (unfold(o, n), unfold(lse, n)), (0, 0)


class FlashAttentionBackward(torch.autograd.Function):
    """(dq, dk, dv) of :class:`FlashAttention` at (q, k, v) with outputs o
    and lse and output gradient do."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal: bool, window: int):
        return flash_attention_bwd_op(q, k, v, o, lse, do, causal, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the flash-attention backward is not "
                                  "differentiable (no double backward)")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window):
        n = info.batch_size
        args = fold((q, k, v, o, lse, do), in_dims[:6], n)
        grads = FlashAttentionBackward.apply(*args, causal, window)
        return tuple(unfold(g, n) for g in grads), (0, 0, 0)


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, S, KV, D) with KV dividing H -> (B, S, H, D),
    differentiable in q, k and v.  With grad mode off (serving, evaluation)
    the forward keeps no row statistics for a backward.

    CPU tensors take the plain version; CUDA tensors launch the kernels or
    raise."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"need q (B, S, H, D) and k/v (B, S, KV, D) with KV "
                         f"dividing H; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return FlashAttention.apply(q, k, v, causal, int(window),
                                torch.is_grad_enabled())[0]
