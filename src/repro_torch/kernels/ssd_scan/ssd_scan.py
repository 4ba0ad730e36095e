"""The Mamba2 SSD scan: the wrapper of ``csrc/ssd_scan.cu``.

Replaces src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan (body
``_ssd_kernel``).  The source note in the .cu file says how the kernel runs
the chunked SSD form on the tensor cores (split TF32, the state kept in
registers across chunks), and what bounds it on the card.  One call runs two
device kernels: C·Bᵀ and the split operands once per (batch, chunk, group)
into a scratch this wrapper allocates, then the chunked scan, which reads
them.
"""
from __future__ import annotations

import torch

from ..build import check_launch, library
from .ref import ssd_apply_ref, ssd_ref

# Launches of the CUDA kernel since the last reset (repro_torch.kernels).
launches = 0

# The kernel's own chunk length (Q in csrc/ssd_scan.cu).
CHUNK = 32


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def check_operands(what: str, ts) -> None:
    """Raise unless ``ts`` (x (b, S, H, P), dt, A, B/C (b, S, G, N), then
    any others) are float32 and contiguous on one CUDA device at a P, N and
    G the SSD kernels take."""
    x, B = ts[0], ts[3]
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"{what} runs on one CUDA device; got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"the kernel takes float32; got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} needs contiguous inputs")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if n % 8 or not 0 < n <= 128 or p % 4:
        raise ValueError(f"the kernel takes N in multiples of 8 up to 128 "
                         f"and P a multiple of 4; got P={p}, N={n}")
    if g == 0 or h % g or b * h >= 2 ** 31 \
            or b * -(-s // CHUNK) * g >= 2 ** 31:
        raise ValueError(f"the kernel takes G dividing H and fewer than 2^31 "
                         f"blocks; got b={b}, S={s}, H={h}, G={g}")


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, *, a_stride: int):
    """x (b, S, H, P), dt (b, S, H), A read at ``[b * a_stride + h]``,
    B/C (b, S, G, N) with G dividing H, all float32 on one CUDA device ->
    (y (b, S, H, P), final_state (b, H, P, N)) float32, by one launch of
    the C entry (two device kernels).  Raises on what the kernel does not
    take."""
    check_operands("ssd_scan", (x, dt, A, B, C))
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b * h * p == 0:
        return y, fin
    lib = library()
    scratch = torch.empty((lib.repro_ssd_scan_scratch_bytes(b, s, g, n),),
                          dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check_launch("ssd_scan", lib.repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), fin.data_ptr(), scratch.data_ptr(), b, s,
        h, p, g, n, a_stride, stream))
    global launches
    launches += 1
    return y, fin


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b, S, H, P), dt (b, S, H), A (b, H), B/C (b, S, G, N) -> (y,
    final_state) float32: CPU tensors take the plain version, CUDA tensors
    one :func:`launch` on float32 copies (or raise).  Its fake form gives
    the shapes alone, so a graph traced over fake tensors holds one node
    for the kernel."""
    if _on_cpu(x, dt, A, B, C):
        return ssd_apply_ref(x, dt, A, B, C)
    return launch(*(t.float().contiguous() for t in (x, dt, A, B, C)),
                  a_stride=x.shape[2])


@ssd_scan_op.register_fake
def _ssd_scan_fake(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p), dtype=torch.float32),
            x.new_empty((b, h, p, B.shape[3]), dtype=torch.float32))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 128):
    """x (BH, S, P); dt (BH, S); A (BH,); B/C (BH, S, N) ->
    (y (BH, S, P) float32, final_state (BH, P, N) float32).  S % chunk == 0,
    as the reference requires; the kernel runs its own chunk of 32 steps,
    masking the tail, and its result does not depend on ``chunk``.

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
    y, fin = ssd_scan_op(x[:, :, None], dt[:, :, None], A[:, None],
                         B[:, :, None], C[:, :, None])
    return y[:, :, 0], fin[:, 0]
