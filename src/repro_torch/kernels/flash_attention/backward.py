"""The gradients of causal / sliding-window GQA attention: the wrapper of
the backward kernels in ``csrc/flash_attention.cu``.

The reference has no TPU kernel here: ``jax.grad`` differentiates the XLA
attention it trains with (``repro/models/layers.py:_sdpa``).  The plain
backward materialises the (S × S) score and probability matrices of every
head; the kernels keep them in shared memory and registers a tile at a
time.  Both dtypes run two kernels on the tensor cores from the forward's
row logsumexp L.  bfloat16: dQ a (b, h, 128-row q-tile), which also writes
L in log2 units and Δ = rowsum(dO∘O) to a scratch (sized by the library)
whose rows are padded to the dK/dV kernel's q-tile, then dK/dV a (b,
kv-head, 128-key tile) over the q-heads of its group.  float32, in split
TF32: dQ a (b, h, 64-row q-tile), which writes Δ to the scratch, then dK/dV
a (b, kv-head, 64-key tile), each block two warpgroups that share a tile's
products.  Both take the forward's head_dims (``BWD_HEAD_DIMS`` is
``HEAD_DIMS``): 64, 96, 128 and 192 in bf16, 16 to 192 in float32.  The
source note says what bounds them and how each head_dim fits the kernels'
shared memory and registers.
"""
from __future__ import annotations

import torch

from ..build import check_launch, library
from .flash_attention import HEAD_DIMS, _ENTRY, _on_cpu, check_operands
from .ref import gqa_attention_bwd_ref

# The head_dims the backward kernels take, by dtype: the forward's.
BWD_HEAD_DIMS = HEAD_DIMS

# Launches of the backward kernels since the last reset (repro_torch.kernels);
# one a call, whatever the number of kernels the call starts.
launches = 0


def launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                    causal: bool, window: int):
    """q/o/do (B, S, H, D), k/v (B, S, KV, D), one dtype (float32 or
    bfloat16) on one CUDA device, and the forward's ``lse`` (B, H, S)
    float32 -> (dq, dk, dv) in that dtype.  Raises on what the kernels do
    not take."""
    ts = (q, k, v, o, do)
    if q.dtype not in _ENTRY or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"need float32 or bfloat16 tensors of one dtype; got "
                        f"{[t.dtype for t in ts]}")
    b, s, h, d = q.shape
    check_operands("flash_attention backward", ts, d, window)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in ts + (lse,)):
        raise ValueError(f"flash_attention backward runs on one CUDA device;"
                         f" got {[str(t.device) for t in ts + (lse,)]}")
    kvh = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or v.shape != k.shape:
        raise ValueError(f"need q/o/do of one shape and k/v of one shape; "
                         f"got {[tuple(t.shape) for t in ts]}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"need the forward's lse, contiguous float32 of "
                         f"shape {(b, h, s)}; got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    lib = library()
    bf16 = q.dtype == torch.bfloat16
    scratch = torch.empty(
        (lib.repro_flash_attention_bwd_scratch_bytes(b, s, h, int(bf16)),),
        dtype=torch.uint8, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (b, s, h, kvh, d, int(causal), window, stream)
    entry = (lib.repro_flash_attention_bf16_bwd if bf16
             else lib.repro_flash_attention_f32_bwd)
    err = entry(*(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv,
                                         scratch)), *tail)
    check_launch("flash_attention backward", err)
    global launches
    launches += 1
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, lse: torch.Tensor,
                           do: torch.Tensor, causal: bool, window: int
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dq, dk, dv): CPU tensors take the plain backward, CUDA tensors one
    :func:`launch_backward` (or raise).  Its fake form gives the shapes
    alone, so a graph traced over fake tensors holds one node for the
    kernels."""
    if _on_cpu(q, k, v, o, lse, do):
        return gqa_attention_bwd_ref(q, k, v, o, do, causal, window)
    return launch_backward(*(t.contiguous() for t in (q, k, v, o, lse, do)),
                           causal=causal, window=window)


@flash_attention_bwd_op.register_fake
def _flash_attention_bwd_fake(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool, window: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
