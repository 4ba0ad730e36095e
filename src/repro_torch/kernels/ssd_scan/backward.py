"""The gradients of the SSD scan: the wrapper of ``csrc/ssd_scan_bwd.cu``.

The reference has no TPU kernel here: ``jax.grad`` differentiates the XLA
chunked form it trains with (``repro/models/layers.py:_ssd_chunked``).  The
plain backward, the vjp of ``ref.ssd_chunked_ref``, runs that chunked form
forwards and backwards in plain PyTorch; the kernels run it on the tensor
cores (wgmma in split TF32, every decay exponent a sum of one sign) and sum
a group's heads in a fixed order.  One call runs six device kernels: C·Bᵀ
and the split shared operands once per (batch, 64-step chunk, group) beside
each head's decay record; a walk forwards writing the state at every
64-step boundary and one backwards writing dx and the state's gradient
there, to a scratch this wrapper allocates; the pass over the chunks that
sums a group's heads inside its products into dB and dC; then ddt and dA
from that pass's sums.  The source note says what bounds them on the card.
"""
from __future__ import annotations

import torch

from ..build import check_launch, library
from .ref import ssd_chunked_ref
from .ssd_scan import _on_cpu, check_operands

# Launches of the backward kernels since the last reset (repro_torch.kernels);
# one a call, whatever the number of kernels the call starts.
launches = 0

# Backward calls on CPU tensors (the plain vjp, no kernel) since the last
# reset; read beside the kernels' launch counts.
vjp_calls = 0


def launch_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, gy: torch.Tensor,
                    gfin: torch.Tensor):
    """x (b, S, H, P), dt (b, S, H), A (b, H), B/C (b, S, G, N) with G
    dividing H, gy (b, S, H, P) and gfin (b, H, P, N), all float32 and
    contiguous on one CUDA device -> (dx, ddt, dA, dB, dC) float32, by one
    launch of the C entry (six device kernels).  Raises on what the
    kernels do not take."""
    check_operands("ssd_scan backward", (x, dt, A, B, C, gy, gfin))
    b, s, h, p = x.shape
    n = B.shape[3]
    if A.shape != (b, h) or gy.shape != x.shape \
            or gfin.shape != (b, h, p, n):
        raise ValueError(f"need A {(b, h)}, gy of x's shape "
                         f"{tuple(x.shape)} and gfin {(b, h, p, n)}; got "
                         f"{tuple(A.shape)}, {tuple(gy.shape)}, "
                         f"{tuple(gfin.shape)}")
    grads = tuple(torch.empty_like(t) for t in (x, dt, A, B, C))
    if b * h * p == 0:
        return tuple(g.zero_() for g in grads)
    lib = library()
    scratch = torch.empty(
        (lib.repro_ssd_scan_bwd_scratch_bytes(b, s, h, p, B.shape[2], n),),
        dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check_launch("ssd_scan backward", lib.repro_ssd_scan_bwd(
        *(t.data_ptr() for t in (x, dt, A, B, C, gy, gfin, *grads, scratch)),
        b, s, h, p, B.shape[2], n, h, stream))
    global launches
    launches += 1
    return grads


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def ssd_scan_bwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, gy: torch.Tensor,
                    gfin: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """(dx, ddt, dA, dB, dC) of ``SSDScan`` at x (b, S, H, P), dt (b, S, H),
    A (b, H), B/C (b, S, G, N) for output gradients gy and gfin.  CPU
    tensors take the plain backward (the vjp of the chunked form at
    ``chunk``), CUDA tensors one :func:`launch_backward` on float32 copies
    (or raise; the kernels run their own chunks of 32 and 64 steps).  Its fake form
    gives the shapes alone, so a graph traced over fake tensors holds one
    node for the kernels."""
    ts = (x, dt, A, B, C, gy, gfin)
    if _on_cpu(*ts):
        global vjp_calls
        vjp_calls += 1
        _, vjp = torch.func.vjp(lambda *a: ssd_chunked_ref(*a, chunk),
                                x, dt, A, B, C)
        return vjp((gy, gfin))
    grads = launch_backward(*(t.float().contiguous() for t in ts))
    return tuple(g.to(t.dtype) for g, t in zip(grads, ts))


@ssd_scan_bwd_op.register_fake
def _ssd_scan_bwd_fake(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, gy: torch.Tensor,
                       gfin: torch.Tensor, chunk: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    return tuple(t.new_empty(t.shape) for t in (x, dt, A, B, C))

