"""Weighted sums over stacked client parameters: the wrapper of
``csrc/weighted_agg.cu``.

Replaces src/repro/kernels/weighted_agg/weighted_agg.py:weighted_agg_kernel.
The source note in the .cu file says what bounds the kernel on the card and
why it is a column reduction on CUDA cores rather than a tensor-core product.
One launch sums every leaf of one dtype (up to ``MAX_LEAVES`` a launch) for
every trial of a grid (the launch's second grid axis): the Python side plans
the table of leaves that the launch takes.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

import torch

from ..build import check_launch, library
from .ref import weighted_agg_ref

_ENTRY = {torch.float32: "repro_weighted_agg_f32",
          torch.bfloat16: "repro_weighted_agg_bf16"}
# The kernel's table size and block size (csrc/weighted_agg.cu), checked
# against the built kernel before its first launch.
MAX_LEAVES = 64
THREADS = 256

# Launches of the CUDA kernel since the last reset (repro_torch.kernels).
launches = 0


class _Entry(ctypes.Structure):
    """One leaf of the kernel's table (``LeafEntry`` in the .cu file)."""
    _fields_ = [("theta", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("first_block", ctypes.c_longlong),
                ("theta_trial", ctypes.c_longlong),
                ("out_trial", ctypes.c_longlong),
                ("vec", ctypes.c_int), ("pad", ctypes.c_int)]


@dataclass(frozen=True)
class LeafSlot:
    """Leaf ``index`` of a launch: ``n`` columns, 16-byte loads if ``vec``,
    blocks ``first_block`` .. ``first_block + blocks - 1``."""
    index: int
    n: int
    vec: bool
    first_block: int
    blocks: int


def vector_width(dtype: torch.dtype) -> int:
    """Elements in one 16-byte load."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def loads_16_bytes(n: int, width: int, *addresses: int) -> bool:
    """Whether a leaf of ``n`` columns at these addresses (input, output)
    takes 16-byte loads of ``width`` elements."""
    return n % width == 0 and all(a % 16 == 0 for a in addresses)


def plan_launches(sizes: Sequence[int], vec: Sequence[bool],
                  width: int) -> list[list[LeafSlot]]:
    """Tables for leaves of ``sizes[i]`` columns (one dtype, ``width``
    elements a 16-byte load): at most ``MAX_LEAVES`` leaves a launch, block
    starts numbered from 0 in each launch.  Empty leaves get no slot."""
    plans: list[list[LeafSlot]] = []
    table: list[LeafSlot] = []
    first = 0
    for i, (n, v) in enumerate(zip(sizes, vec)):
        if n == 0:
            continue
        if len(table) == MAX_LEAVES:
            plans.append(table)
            table, first = [], 0
        threads = n // width if v else n
        blocks = -(-threads // THREADS)
        table.append(LeafSlot(i, n, bool(v), first, blocks))
        first += blocks
    if table:
        plans.append(table)
    return plans


def launch_tables(leaves: Sequence[torch.Tensor],
                  outs: Sequence[torch.Tensor]
                  ) -> list[tuple[torch.dtype, list[LeafSlot]]]:
    """The launches that sum ``leaves`` (T, K, N_i) into ``outs`` (T, N_i):
    one table a dtype (float32, then bfloat16), split every ``MAX_LEAVES``
    leaves, each slot's ``index`` the leaf's position in ``leaves``.  16-byte
    loads where N_i and both tensors' addresses allow them (every trial's
    rows then start 16-byte aligned too: K·N_i and N_i are multiples of the
    vector width)."""
    tables = []
    for dtype in _ENTRY:
        group = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        width = vector_width(dtype)
        vec = [loads_16_bytes(leaves[i].shape[-1], width, leaves[i].data_ptr(),
                              outs[i].data_ptr()) for i in group]
        for table in plan_launches([leaves[i].shape[-1] for i in group], vec,
                                   width):
            tables.append((dtype, [replace(slot, index=group[slot.index])
                                   for slot in table]))
    return tables


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The kernel library, once its launch geometry is checked against the
    one these tables are planned with: blocks narrower than ``THREADS``
    would leave columns unsummed, and no error would say so."""
    lib = library()
    got = [ctypes.c_int() for _ in range(3)]
    lib.repro_weighted_agg_geometry(*(ctypes.byref(x) for x in got))
    want = (THREADS, MAX_LEAVES, ctypes.sizeof(_Entry))
    if tuple(x.value for x in got) != want:
        raise RuntimeError(f"weighted_agg: the kernel's (threads, leaves, "
                           f"entry bytes) {tuple(x.value for x in got)} differ "
                           f"from the wrapper's {want}")
    return lib


def _check_leaves(leaves: Sequence[torch.Tensor], scales: torch.Tensor,
                  denom: Optional[torch.Tensor]) -> None:
    """Leaves (K, N) with scales (K,) and one denom value, or leaves
    (T, K, N) with scales (T, K) and denom (T,)."""
    if scales.dim() not in (1, 2):
        raise ValueError(f"need scales (K,) or (T, K); got "
                         f"{tuple(scales.shape)}")
    for x in leaves:
        if x.dim() != scales.dim() + 1 or x.shape[:-1] != scales.shape:
            raise ValueError(f"need stacked {tuple(scales.shape)} + (N,) "
                             f"leaves; got {tuple(x.shape)}")
    trials = 1 if scales.dim() == 1 else scales.shape[0]
    if denom is not None and denom.numel() != trials:
        raise ValueError(f"denom must hold one value a trial ({trials}); got "
                         f"{tuple(denom.shape)}")


def weighted_agg_leaves(leaves: Sequence[torch.Tensor], scales: torch.Tensor,
                        denom: Optional[torch.Tensor] = None
                        ) -> list[torch.Tensor]:
    """Each leaf (K, N_i) float32 or bfloat16 -> (N_i,)
    ``sum_k scales[k] * leaf[k]``, accumulated in float32, divided by
    ``denom`` (one float32 value) in float32 when given, rounded once to the
    leaf's dtype.  With a trial axis, leaves (T, K, N_i), scales (T, K) and
    denom (T,) -> (T, N_i), each trial summed as it would be alone.

    CPU tensors take the plain version.  CUDA tensors make one kernel launch
    for the leaves of each dtype (one per ``MAX_LEAVES`` leaves) for all
    trials, or raise.  Both go through the ``repro_torch::weighted_agg``
    op, whose fake form gives the shapes alone, so a graph traced over fake
    tensors holds one node for the kernel's launches."""
    _check_leaves(leaves, scales, denom)
    return weighted_agg_op(list(leaves), scales, denom)


@torch.library.custom_op("repro_torch::weighted_agg", mutates_args=())
def weighted_agg_op(leaves: List[torch.Tensor], scales: torch.Tensor,
                    denom: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """The op behind :func:`weighted_agg_leaves` (inputs already checked)."""
    tensors = [*leaves, scales] + ([] if denom is None else [denom])
    if all(t.device.type == "cpu" for t in tensors):
        return [weighted_agg_ref(x, scales, denom) for x in leaves]
    dev = scales.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"weighted_agg runs on one CUDA device; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if scales.dtype != torch.float32 or (denom is not None
                                         and denom.dtype != torch.float32):
        raise TypeError(f"need float32 scales and denom; got {scales.dtype}"
                        f" and {None if denom is None else denom.dtype}")
    if any(x.dtype not in _ENTRY for x in leaves):
        raise TypeError(f"need float32 or bfloat16 leaves; got "
                        f"{sorted({str(x.dtype) for x in leaves})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("weighted_agg needs contiguous inputs")
    batched = scales.dim() == 2
    trials, k_clients = (scales.shape if batched else (1, scales.shape[0]))
    outs = [torch.empty(x.shape[:-2] + x.shape[-1:], dtype=x.dtype,
                        device=dev) for x in leaves]
    stream = torch.cuda.current_stream(dev).cuda_stream
    denom_ptr = None if denom is None else denom.data_ptr()
    global launches
    for dtype, table in launch_tables(leaves, outs):
        rows = (_Entry * len(table))(*(
            _Entry(leaves[slot.index].data_ptr(), outs[slot.index].data_ptr(),
                   slot.n, slot.first_block, k_clients * slot.n, slot.n,
                   int(slot.vec), 0)
            for slot in table))
        blocks = table[-1].first_block + table[-1].blocks
        entry = getattr(_kernel_library(), _ENTRY[dtype])
        check_launch("weighted_agg", entry(
            ctypes.addressof(rows), len(table), blocks, trials,
            scales.data_ptr(), k_clients, k_clients, denom_ptr, 1, stream))
        launches += 1
    return outs


@weighted_agg_op.register_fake
def _weighted_agg_fake(leaves: List[torch.Tensor], scales: torch.Tensor,
                       denom: Optional[torch.Tensor]) -> List[torch.Tensor]:
    return [x.new_empty(x.shape[:-2] + x.shape[-1:]) for x in leaves]


def weighted_agg_kernel(stacked: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """stacked (K, N) float32 or bfloat16, scales (K,) float32 -> (N,)
    ``sum_k scales[k] * stacked[k]`` in ``stacked``'s dtype, accumulated in
    float32: one leaf of :func:`weighted_agg_leaves`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if stacked.dim() != 2 or scales.shape != stacked.shape[:1]:
        raise ValueError(f"need stacked (K, N) and scales (K,); got "
                         f"{tuple(stacked.shape)} and {tuple(scales.shape)}")
    return weighted_agg_leaves([stacked], scales)[0]
