"""Blockwise causal / sliding-window / bidirectional attention with online
softmax: the wrapper of ``csrc/flash_attention.cu``.

Replaces src/repro/kernels/flash_attention/flash_attention.py:flash_attention
(body ``_flash_kernel``).  bfloat16 runs on the tensor cores (wgmma, TMA) at
head_dim 64, 96, 128 and 192, float32 on the tensor cores in split TF32
(each operand hi + lo, three TF32 products) at head_dim 16, 32, 64, 96, 128
and 192.  ``causal=False`` (the audio encoder's bidirectional attention)
masks only the keys past S.  The source note in the .cu file says what
bounds the kernels on the card, how the TPU's sequential key-block grid axis
became a loop inside one CUDA block, why the bf16 kernel splits P in two and
why the float32 kernels split every operand.
"""
from __future__ import annotations

import torch

from ..build import check_launch, library
from .ref import attention_ref, gqa_attention_ref

_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}
HEAD_DIMS = {torch.float32: (16, 32, 64, 96, 128, 192),
             torch.bfloat16: (64, 96, 128, 192)}

# Launches of the CUDA kernel since the last reset (repro_torch.kernels).
launches = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int, with_lse: bool = False):
    """q (B, S, H, D), k/v (B, S, KV, D) on one CUDA device -> (B, S, H, D)
    in q's dtype, by one kernel launch that reads kv-head ``h // (H // KV)``
    for q-head h.  With ``with_lse`` it returns ``(o, lse)``: the kernel
    also writes each row's logsumexp of the scaled, masked scores, (B, H, S)
    float32, and ``o`` is the same bits as without.  Raises on what the
    kernel does not take."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention runs on one CUDA device; got "
                         f"{q.device}, {k.device} and {v.device}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"need float32 or bfloat16 q/k/v of one dtype; got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    check_operands("flash_attention", (q, k, v), d, window)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check_launch("flash_attention", getattr(library(), _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b, s, h, kvh, d, int(causal),
        window, stream))
    global launches
    launches += 1
    return (out, lse) if with_lse else out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int, with_lse: bool
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, H, D), k/v (B, S, KV, D) -> (o, lse): CPU tensors take the
    plain version, CUDA tensors one :func:`launch` (or raise).  Without
    ``with_lse`` lse is an empty (B, H, 0).  Its fake form gives the shapes
    alone, so a graph traced over fake tensors holds one node for the
    kernel."""
    if _on_cpu(q, k, v):
        out = gqa_attention_ref(q, k, v, causal, window, with_lse=with_lse)
    else:
        out = launch(q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=causal, window=window, with_lse=with_lse)
    if with_lse:
        return out
    b, s, h, _ = q.shape
    return out, q.new_empty((b, h, 0), dtype=torch.float32)


@flash_attention_op.register_fake
def _flash_attention_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, window: int, with_lse: bool
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, s if with_lse else 0), dtype=torch.float32))


def check_operands(name: str, ts, d: int, window: int) -> None:
    """Raise on what the kernels do not take: head_dim outside
    ``HEAD_DIMS`` of the dtype, tensors not contiguous or not starting on a
    16-byte boundary (they load 16 bytes at once), a negative window."""
    if d not in HEAD_DIMS[ts[0].dtype]:
        raise ValueError(f"{name} takes head_dim in "
                         f"{HEAD_DIMS[ts[0].dtype]} for {ts[0].dtype}; "
                         f"got {d}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError(f"{name} needs contiguous tensors starting on "
                         "16-byte boundaries (it loads 16 bytes at once)")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q/k/v (BH, S, D) float32 or bfloat16 -> (BH, S, D) in q's dtype;
    scale 1/sqrt(D), float32 softmax and accumulation; ``window=0`` is full
    causal, ``causal=False`` attends to every key.  Any S: keys past S are
    masked in the kernel, not padded.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q/k/v of one (BH, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if _on_cpu(q, k, v):
        return attention_ref(q, k, v, causal, window)
    return flash_attention_op(q[:, :, None], k[:, :, None], v[:, :, None],
                              causal, window, False)[0][:, :, 0]
