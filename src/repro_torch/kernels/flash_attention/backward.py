"""The gradients of causal / sliding-window GQA attention: the wrapper of
the backward kernel pair in ``csrc/flash_attention.cu``.

The reference has no TPU kernel here: ``jax.grad`` differentiates the XLA
attention it trains with (``repro/models/layers.py:_sdpa``).  The plain
backward materialises the (S × S) score and probability matrices of every
head; the kernel pair keeps them in shared memory and registers a tile at a
time.  One call launches two kernels on the current stream: (a) dQ a
(b, h, q-tile), writing each row's logsumexp L and Δ = rowsum(dO∘O) to a
scratch this wrapper allocates; (b) dK and dV a (b, kv-head, k-tile), over
the q-heads of its group.  The source note says what bounds them.
"""
from __future__ import annotations

import torch

from ..build import check_launch, library
from .flash_attention import _ENTRY, check_operands

# Launches of the backward kernel pair since the last reset
# (repro_torch.kernels); one a call.
launches = 0


def launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                    window: int):
    """q/o/do (B, S, H, D), k/v (B, S, KV, D), one dtype (float32 or
    bfloat16) on one CUDA device -> (dq, dk, dv) in that dtype.  Raises on
    what the kernels do not take."""
    ts = (q, k, v, o, do)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"flash_attention backward runs on one CUDA device;"
                         f" got {[str(t.device) for t in ts]}")
    if q.dtype not in _ENTRY or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"need float32 or bfloat16 tensors of one dtype; got "
                        f"{[t.dtype for t in ts]}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or v.shape != k.shape:
        raise ValueError(f"need q/o/do of one shape and k/v of one shape; "
                         f"got {[tuple(t.shape) for t in ts]}")
    check_operands("flash_attention backward", ts, d, window)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    scratch = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check_launch("flash_attention backward", getattr(
        library(), _ENTRY[q.dtype] + "_bwd")(
        *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, scratch)), b,
        s, h, kvh, d, int(causal), window, stream))
    global launches
    launches += 1
    return dq, dk, dv
