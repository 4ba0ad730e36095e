"""Per-client label histograms: the wrapper of ``csrc/label_hist.cu``.

Replaces src/repro/kernels/label_hist/label_hist.py:label_hist_kernel.  The
source note in the .cu file says what bounds the kernel on the card and how it
counts.  ``plan_hist`` cuts the work to fill the card whatever (B, n) is: a
*team* of 1-8 warps counts one segment of one row, and the plan sets the
team's width, the rows a block and whether rows are cut into chunks (then the
output is zeroed first and each chunk adds its counts).  ``label_hist_kernel``
plans for the multiprocessors of the tensors' card and launches once.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..build import check_launch, library
from .ref import label_hist_ref

# Warps a block (the kernel's launch bound).
MAX_WARPS = 8
# Warps a multiprocessor the plan aims to keep busy when rows are few: all
# that the kernel's launch bound (4 blocks of 8 warps) lets be resident.
FILL_WARPS_PER_SM = 32
# Samples a warp counts at least before a row is shared by more warps.
MIN_WARP_SAMPLES = 1024
# Shared memory a block may take without an opt-in attribute, in int32 bins;
# with C > 32 each warp of a block has its own C bins, so it also bounds C.
SMEM_INTS = 48 * 1024 // 4
# Float counts are exact integers below 2^24.
MAX_SAMPLES = 1 << 24

# Launches of the CUDA kernel since the last reset (repro_torch.kernels).
launches = 0


@dataclass(frozen=True)
class HistPlan:
    """One launch: ``blocks`` blocks of ``rows_per_block`` teams of
    ``team_threads`` threads (1, 2, 4 or 8 warps).  Team ``t`` counts the
    samples
    ``[row * n + k * chunk, min(row * n + (k + 1) * chunk, (row + 1) * n))``
    of ``row = t // chunks_per_row``, ``k = t % chunks_per_row``."""
    rows_per_block: int
    team_threads: int
    chunks_per_row: int
    chunk: int
    blocks: int
    smem_bytes: int

    @property
    def threads(self) -> int:
        return self.rows_per_block * self.team_threads

    @property
    def zero_out(self) -> bool:
        """Chunks add into the output, so it must start at zero."""
        return self.chunks_per_row > 1


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def plan_hist(rows: int, n: int, num_classes: int, sms: int) -> HistPlan:
    """The launch for a (rows, n) input with ``num_classes`` bins on a card
    of ``sms`` multiprocessors.

    Rows are given warps until the card holds ``FILL_WARPS_PER_SM`` warps a
    multiprocessor, no warp counting fewer than ``MIN_WARP_SAMPLES``
    samples: one warp a row when rows are many or short, up to a block's
    warps a row, and beyond that a row is cut into chunks of one block each.
    Teams are grouped so that the blocks spread over the multiprocessors
    (one row a block when rows are fewer than them)."""
    max_warps = MAX_WARPS
    if num_classes > 32:                       # a warp's own shared bins
        max_warps = _pow2_floor(min(MAX_WARPS, SMEM_INTS // num_classes))
    want = -(-sms * FILL_WARPS_PER_SM // max(rows, 1))   # warps a row
    warps = max(1, min(want, n // MIN_WARP_SAMPLES))
    if warps <= max_warps:
        team, chunks, chunk = _pow2_floor(warps) * 32, 1, n
    else:
        team = max_warps * 32
        chunks = -(-warps // max_warps)
        chunk = -(-n // chunks)
        chunk = -(-chunk // 128) * 128          # whole warp steps
        chunks = -(-n // chunk)
    if chunks > 1:
        rpb = 1
    else:
        rpb = _pow2_floor(min(max_warps * 32 // team, -(-rows // sms)))
    teams = rows * chunks
    if teams >= 1 << 31:
        raise ValueError(f"{rows} rows in {chunks} chunks: the kernel numbers "
                         f"its teams in 32 bits")
    return HistPlan(rows_per_block=rpb, team_threads=team,
                    chunks_per_row=chunks, chunk=chunk,
                    blocks=-(-teams // rpb),
                    smem_bytes=_smem_bytes(rpb, team, num_classes))


def _smem_bytes(rows_per_block: int, team_threads: int,
                num_classes: int) -> int:
    """Shared memory the kernel indexes: C bins a warp when C > 32, else one
    int a thread to sum a team of several warps."""
    if num_classes > 32:
        return rows_per_block * team_threads // 32 * num_classes * 4
    return rows_per_block * team_threads * 4 if team_threads > 32 else 0


def _check_plan(plan: HistPlan, rows: int, n: int, num_classes: int) -> None:
    """Raise unless ``plan`` counts every sample of a (rows, n) input once
    within the kernel's limits."""
    teams = rows * plan.chunks_per_row
    faults = []
    if plan.team_threads not in (32, 64, 128, 256):
        faults.append("a team is 1, 2, 4 or 8 warps")
    if not 0 < plan.threads <= MAX_WARPS * 32:
        faults.append(f"a block has 1 to {MAX_WARPS * 32} threads")
    if plan.chunks_per_row < 1 or plan.chunk < 0:
        faults.append("a row has at least one chunk")
    elif plan.chunk * plan.chunks_per_row < n or (
            plan.chunks_per_row > 1
            and plan.chunk * (plan.chunks_per_row - 1) >= n):
        faults.append(f"the chunks cover the {n} samples of a row, none empty")
    if not teams <= plan.blocks * plan.rows_per_block < 1 << 31:
        faults.append(f"the blocks hold the {teams} teams, numbered in 32 bits")
    need = _smem_bytes(plan.rows_per_block, plan.team_threads, num_classes)
    if not need <= plan.smem_bytes <= SMEM_INTS * 4:
        faults.append(f"shared memory is {need} to {SMEM_INTS * 4} bytes")
    if faults:
        raise ValueError(f"{plan} for ({rows}, {n}) and C = {num_classes}: "
                         + "; ".join(faults))


def _check(labels: torch.Tensor, valid: torch.Tensor) -> None:
    if labels.dim() != 2 or valid.shape != labels.shape:
        raise ValueError(f"need labels and valid of one (B, n) shape; got "
                         f"{tuple(labels.shape)} and {tuple(valid.shape)}")
    if labels.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"need int32 labels and bool valid; got {labels.dtype} "
                        f"and {valid.dtype}")
    if labels.shape[1] >= MAX_SAMPLES:
        raise ValueError(f"n = {labels.shape[1]} samples a row: counts from "
                         f"2^24 on are not exact in float32")


def _check_cuda(labels: torch.Tensor, valid: torch.Tensor,
                num_classes: int) -> None:
    if labels.device.type != "cuda" or valid.device != labels.device:
        raise ValueError(f"label_hist_kernel runs on one CUDA device; got "
                         f"{labels.device} and {valid.device}")
    if not (labels.is_contiguous() and valid.is_contiguous()):
        raise ValueError("label_hist_kernel needs contiguous inputs")
    if not 0 < num_classes <= SMEM_INTS:
        raise ValueError(f"num_classes must be in [1, {SMEM_INTS}]; "
                         f"got {num_classes}")


def label_hist_kernel(labels: torch.Tensor, valid: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """labels (B, n) int32, valid (B, n) bool -> (B, C) float32 counts.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    once, as ``plan_hist`` cuts the work for its card, or raises.  Both go
    through the ``repro_torch::label_hist`` op, whose fake form gives the
    shape alone, so a graph traced over fake tensors holds one node for
    the kernel."""
    _check(labels, valid)
    return label_hist_op(labels, valid, num_classes)


@torch.library.custom_op("repro_torch::label_hist", mutates_args=())
def label_hist_op(labels: torch.Tensor, valid: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """The op behind :func:`label_hist_kernel` (inputs already checked)."""
    if labels.device.type == "cpu" and valid.device.type == "cpu":
        return label_hist_ref(labels, valid, num_classes)
    _check_cuda(labels, valid, num_classes)
    sms = torch.cuda.get_device_properties(labels.device).multi_processor_count
    return _launch_plan(labels, valid, num_classes,
                        plan_hist(*labels.shape, num_classes, sms))


@label_hist_op.register_fake
def _label_hist_fake(labels: torch.Tensor, valid: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    return labels.new_empty((labels.shape[0], num_classes),
                            dtype=torch.float32)


def _launch_plan(labels: torch.Tensor, valid: torch.Tensor, num_classes: int,
                 plan: HistPlan) -> torch.Tensor:
    """One launch of ``plan`` on CUDA tensors, checked against their shape
    (``label_hist_kernel`` passes ``plan_hist``'s; a timing script may pass
    another)."""
    _check(labels, valid)
    rows, n = labels.shape
    _check_plan(plan, rows, n, num_classes)
    _check_cuda(labels, valid, num_classes)
    alloc = torch.zeros if plan.zero_out else torch.empty
    out = alloc((rows, num_classes), dtype=torch.float32,
                device=labels.device)
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(labels.device).cuda_stream
    check_launch("label_hist", library().repro_label_hist(
        labels.data_ptr(), valid.data_ptr(), out.data_ptr(), rows, n,
        num_classes, plan.rows_per_block, plan.team_threads,
        plan.chunks_per_row, plan.chunk, plan.blocks, plan.smem_bytes,
        stream))
    global launches
    launches += 1
    return out
