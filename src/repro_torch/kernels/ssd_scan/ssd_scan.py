"""The Mamba2 SSD scan: the wrapper of ``csrc/ssd_scan.cu``.

Replaces src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan (body
``_ssd_kernel``).  The source note in the .cu file says which of the two
simple forms the kernel takes (the plain recurrence, state in registers),
why, and what bounds it on the card.
"""
from __future__ import annotations

import torch

from ..build import check_launch, library
from .ref import ssd_ref

# Launches of the CUDA kernel since the last reset (repro_torch.kernels).
launches = 0


def _state_lanes(n: int) -> int:
    """Threads that share one state row in the kernel (32 columns each), or
    0 if the kernel does not take this N (32 times a power of two up to
    32)."""
    lanes = n // 32
    if n % 32 or not lanes or lanes > 32 or lanes & (lanes - 1):
        return 0
    return lanes


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, *, a_stride: int):
    """x (b, S, H, P), dt (b, S, H), A read at ``[b * a_stride + h]``,
    B/C (b, S, G, N) with G dividing H, all float32 on one CUDA device ->
    (y (b, S, H, P), final_state (b, H, P, N)) float32, by one launch.
    Raises on what the kernel does not take."""
    ts = (x, dt, A, B, C)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"ssd_scan runs on one CUDA device; got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"the kernel takes float32; got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan needs contiguous inputs")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    lanes = _state_lanes(n)
    if not lanes or p * lanes > 1024:
        raise ValueError(f"the kernel takes N in 32·2^k up to 1024 "
                         f"and P·lanes <= 1024; got P={p}, N={n}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b * h * p == 0:
        return y, fin
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check_launch("ssd_scan", library().repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), fin.data_ptr(), b, s, h, p, g, n,
        a_stride, stream))
    global launches
    launches += 1
    return y, fin


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 128):
    """x (BH, S, P); dt (BH, S); A (BH,); B/C (BH, S, N) ->
    (y (BH, S, P) float32, final_state (BH, P, N) float32).  S % chunk == 0,
    as the reference requires (the kernel itself does not chunk).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (inputs cast to float32, as the TPU kernel casts them) or raise."""
    bh, s, p = x.shape
    if dt.shape != (bh, s) or A.shape != (bh,) or B.shape[:2] != (bh, s) \
            or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"need x (BH, S, P), dt (BH, S), A (BH,), B/C "
                         f"(BH, S, N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    if _on_cpu(x, dt, A, B, C):
        return ssd_ref(x, dt, A, B, C)
    # Rows as batch entries of one head each: (BH, S, 1, ...), A[row].
    x, dt, A, B, C = (t.float().contiguous() for t in (x, dt, A, B, C))
    y, fin = launch(x[:, :, None], dt[:, :, None], A, B[:, :, None],
                    C[:, :, None], a_stride=1)
    return y[:, :, 0], fin[:, 0]
