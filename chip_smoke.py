#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and print the build time and the compiler's register report;
   check from ``cuobjdump -sass`` that the bf16 flash kernels (the forward
   and the backward's dQ and dK/dV kernels) and both SSD scan kernels run
   on the tensor cores (``HGMMA``, ``HMMA``) and from the ``-Xptxas -v``
   log that they spill nothing;
3. hold ``label_hist`` against its plain version on the card, bit-equal, at
   the round's shapes, the batched grid's (10500, 290, 10), long rows
   (8, 2^20, 10), C = 1 and 33, n = 0, 1 and 31, rows shared by 8 and 4
   warps, long rows with C > 32, rows that start off a 16-byte boundary,
   all-invalid rows and labels of -1 and C only;
4. hold ``weighted_agg`` against its plain version on the card at every leaf
   shape of the paper CNN with K=30 clients, in float32 and bfloat16, then
   the whole round's tree in one call (one launch), plain and as the masked
   mean;
5. run one paper-width FL round (``make_fl_round``, 1 local epoch) on the
   card and on the CPU from the same NumPy-made inputs, with sgd and with
   Adam: selections bit-equal, params within ``SGD_ATOL`` (sgd) and
   updates within ``ADAM_REL`` of their norm (Adam);
6. the main path: ``run_fl_host`` for 3 rounds at paper width (case1b,
   labelwise, fedavg) on the card, with every kernel's launch count set to 0
   just before and read just after (1 label_hist and 1 weighted_agg launch
   a round);
7. time each kernel at the main path's shapes with CUDA events (device
   time per call), beside its bound, its plain version and one PyTorch call
   computing the same function; ``label_hist`` also beside the launch floor
   (``torch.cuda._sleep(0)`` timed the same way), and at the grid's shape
   cold (each call on the next of 9 copies of the inputs, 137 MB in all),
   warm and as ``torch.bincount``, and at (1000, 4096, 62) and
   (8, 2^20, 10) cold, each beside its bound;
8. hold ``flash_attention`` against its plain version on the card at
   qwen3-14b's prefill shape (BH=160, S=1024, D=128, bf16), causal and with
   window=256, at an unaligned float32 shape (8, 77, 64), at the bf16
   kernel's edges ((8, 77, 64); (8, 1000, 128) causal and with window=256;
   both shapes without the causal mask),
   and through the GQA wrapper at (4, 1024, 40, 128) x (4, 1024, 8, 128) and
   (2, 333, 40, 128) x (2, 333, 8, 128);
9. hold ``ssd_scan`` (``ssd_apply``) against its plain version on the card at
   mamba2-1.3b's prefill shape (b=4, S=1024, H=64, P=64, G=1, N=128), at
   reduced shapes and on a long, strongly decaying sequence (S=2048, dt up
   to 10, A near -10);
10. serve both archs at ``reduced(dtype="float32")`` on the card and on the
    CPU from the same weights and tokens, TF32 off: prefill logits, every
    cache and every decode step's logits within ``SERVE_TOL``;
11. the serving main path: ``run_serve(arch, batch=4, prompt_len=1024,
    gen=16, reduced=False)`` for qwen3-14b, then for mamba2-1.3b, with the
    launch counts set to 0 just before and read just after (40
    flash_attention and 48 ssd_scan launches, one per layer of the prefill;
    decode launches neither); then, on fresh full-width weights in bf16 and
    in float32, prefill ≡ forward at the last prompt position and one decode
    step ≡ forward at the next, held to ``SELF_TOL_BF16`` and
    ``SELF_TOL_F32``;
12. time ``flash_attention`` and ``ssd_scan`` at phase 11's shapes, the
    forward in turns without and with the row logsumexp it writes for the
    backward (output bit-identical);
13. the grid engine (``run(ExperimentSpec(engine="sim"))``), in four parts:
    (a) ``repro_torch.rng`` on the card against threefry known answers
    taken from JAX (bits, keys and uniforms bit-equal, normals within
    ``NORMAL_ULP``) and against the same draws on the CPU; (b) the main
    path of this slice: 7 cases x (random, labelwise, kl) x 1 seed = 21
    trials at the paper's per-trial width for 2 rounds, with the launch
    counts set to 0 just before and read just after (1 ``label_hist`` and 1
    ``weighted_agg`` launch a round, none of the LM kernels); (c) three
    trials of a TF32-off grid against the host loop on the card:
    histograms, masks, orders and ``num_selected`` bit-equal, parameters
    within ``ADAM_REL`` of the update, loss and accuracy within
    ``GRID_LOSS_REL`` and ``GRID_ACC_ATOL``; (d) ``weighted_agg`` with the
    trial axis (21 trials) bit-equal to per-trial launches and timed beside
    its bound, and ``label_hist`` timed on the engine's own (2100, 290, 10)
    round-0 inputs;
14. clustered and robust aggregation through the grid engine at the same
    21-trial paper width for 2 rounds, TF32 as PyTorch's defaults:
    (a) ``clustered_fedavg4`` with the launch counts set to 0 just before
    and read just after (1 ``label_hist`` and 4 ``weighted_agg`` launches a
    round); (b) ``median``, ``trimmed_mean`` and ``krum``, each under
    ``poison`` (scale -4) and ``stale_update`` (tau 1) on a quarter of the
    clients (1 ``label_hist`` launch a round, no ``weighted_agg``); (c) three
    TF32-off trials against ``run_fl_host`` on the card, clustered and with
    ``krum`` + ``poison``: assignments, masks, orders and ``num_selected``
    bit-equal, parameters within ``ADAM_REL``, loss and accuracy within
    ``GRID_LOSS_REL``/``GRID_ACC_ATOL``; (d) k-means of the round-0
    (21, 100, 10) histograms bit-equal to the same call on the CPU, and the
    three reducers at the CNN's leaves with K = 30 against the CPU (median
    bit-equal, trimmed mean within ``TRIM_ULP``, Krum's pick equal), each
    timed on the grid's (21, 30, ...) update stack, beside the clustered
    round's four ``weighted_agg`` launches; (e) (a) again with
    ``telemetry=("auto",)``, its trajectories bit-identical to (a);
15. the population engines (``fl.population``): (a) ``run(ExperimentSpec(
    engine="hier"))`` at the paper's width, case1b x (labelwise, random) x
    1 seed, 2 rounds, 10 blocks of 10, with the launch counts set to 0 just
    before and read just after (1 ``label_hist`` launch a round for all ten
    blocks, no ``weighted_agg``: the two-tier sum is a plain product);
    (b) ``engine="async"`` likewise under ``availability(0.3)``, buffer_k
    10, tau_max 2, alpha 0.5 (1 ``label_hist`` and 1 ``weighted_agg``
    launch a window, the K arrivals' means on its trial axis), with nonzero
    delays; then, TF32 off, hier's selections bit-equal to sim's
    ``order[:budget]`` and both degenerate async (tau_max 0, K = E,
    ``full``) and hier within the reference's 1e-5 of sim; (c)
    ``make_population_round`` at the reference benchmark's sweep (blocks
    of 256, 32 selected, 8 samples a client, SGD), one round at N = 2^10,
    2^13, 2^17 and 2^20 with its wall time, peak memory
    (``max_memory_allocated``, reset between; flat once the chunks are
    full) and launch counts (one ``label_hist`` a chunk of blocks and one
    for the selected rows); at N = 2^13 ids, live flags, scores and
    statistics bit-equal to the CPU and across chunkings; (d)
    ``label_hist`` bit-equal to its plain version at (32, 8, 10),
    (256, 8, 10) and the chunk's (65536, 8, 10), and ``weighted_agg`` at
    async's (10 arrivals, 10 clients, the CNN's leaves), each timed beside
    its bound.

16. LM training: (a) the flash backward kernels against the plain
    backward at ``BWD_SHAPES`` (bf16, the tensor-core kernels, at
    qwen3-14b's (4, 1024, 40/8, 128) causal and window 256, head_dim 64,
    GQA groups 1, 5 and 8, S of 77, 190, 257, 300 and 333, windows of 20,
    33 and 40, no causal mask; float32, the CUDA-core pair, at head_dim 16,
    32, 64 and 128, GQA groups 1, 2 and 5, ragged S, a window of 5, no
    causal mask), each within ``BWD_TOL`` of its max |grad| of the plain
    backward and of a float64 plain backward, with the plain backward's own
    error against float64 printed beside it; the bf16 kernels' time at
    qwen3-14b's shape beside their bound, the plain backward, SDPA's
    backward and the float32 pair at the same shape; (b) the SSD
    Function's gradients at mamba2-1.3b's widths, card against CPU, and the
    time of its backward (the plain chunked form's vjp); (c) ``vmap(grad)`` of a reduced LM over 6 clients: equal
    to 6 separate calls and one flash launch each way a layer; (d) the
    model's gradients card against CPU (the attention and SSD branches
    carry their gradients); (e) the ``lm`` FL workload through ``run``:
    examples/fl_lm_pretrain.py's spec for 3 rounds on ``sim`` (1
    ``label_hist`` and 1 ``weighted_agg`` launch a round) and ``host``, the
    registered micro ``lm`` (head_dim 16) for 2 rounds, each card against
    CPU with selections bit-equal, then fl-lm-12m at the paper's FL width
    (N = 100, 30 a round) with its wall a round and peak memory; (f)
    ``run_train`` at full width, mamba2-1.3b at full depth and qwen3-14b cut
    to 4 layers, 5 steps of 4 x 1024 tokens: step time, tokens/s, the
    token draw's share, peak memory and launches a step; losses finite and
    the last below the first.

The line before the last is a JSON object with each kernel's numbers
(``label_hist``'s also ``floor_ms``, the synthetic grid's cold ``grid_ms``,
phase 13's ``engine_grid_*`` and phase 15's ``hier_launches``,
``async_launches`` and ``population_*``; ``weighted_agg``'s also phase 13's
``trial_axis_*``, phase 14's ``clustered_*`` and phase 15's ``async_*``;
``ssd_scan``'s phase 16's ``train_launches`` and ``backward_*``;
``flash_attention``'s phase 12's ``lse_ms``; the backward kernels
``flash_attention_bwd``, its ``launches`` those of phase 16f's qwen3-14b
run, ``fl_launches`` phase 16e's sim run and ``f32_pair_ms`` the float32
pair at the same shape); the last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or
without the checkout's ``src/repro_torch`` beside this file, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth, the
# float32 rate outside the tensor cores (label_hist and weighted_agg run
# there) and the TF32 rate of the tensor cores (the SSD scan's products).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

K_CLIENTS = 30
# The H100's top SM clock, to turn a host time into spin-kernel cycles (a
# lower clock only makes the spin longer).
SPIN_HZ = 1.98e9
# Phase 5 runs one paper-width round, cut in depth to 1 local epoch (30
# clients × 10 steps), on the card and on the CPU, with either optimizer.
# Both sides compute in float32 with TF32 off, but cuDNN/cuBLAS and the CPU's
# kernels sum in other orders and round exp/log differently, so one step's
# gradients differ by about 1e-7 relative.
# * SGD moves each parameter by lr × gradient, so the rounds stay within
#   ~1e-7 × lr × steps of each other; SGD_ATOL is 1% of one lr-size step.
# * Adam scales each coordinate by its own gradient's size: a coordinate
#   whose gradient is rounding noise takes a full ±lr step whose sign may
#   differ between the sides (a max |diff| of 1.1e-4 was measured on such a
#   coordinate, H100 80GB HBM3 at 700 W).  Adam is held in norm instead: the
#   two rounds' parameter updates may differ by ADAM_REL of the update's norm,
#   where a wrong selection, reduction or kernel differs by order one.
ROUND_EPOCHS = 1
SGD_ATOL = 1e-5
ADAM_REL = 1e-2
# bf16 peak of the tensor cores (NVIDIA's data sheet, dense): the rate that
# bounds attention's products in bf16.
BF16_OPS_PER_S = 989e12
# Phase 8: float32 attention against its plain version, the reference's own
# pin (tests/test_kernels.py); softmax sums of up to S terms in another
# order differ by ~1e-6.  bfloat16: both sides round a float32 result once,
# so they may land one bfloat16 ulp apart, 2^-7 of the value at most.
FLASH_F32_TOL = 2e-5
# Phase 9: the reference's pin for the SSD scan (tests/test_kernels.py).
SSD_TOL = 1e-4
# Phase 10: card against CPU at reduced size in float32, TF32 off: the pin
# that holds the port to the reference on the CPU (tests/test_torch_lm.py);
# cuBLAS, the kernels and the CPU's BLAS sum in other orders (~1e-6).
SERVE_TOL = 2e-4
# Phase 11: prefill/decode against forward at full width, as
# max |diff| / (1 + |forward|) of the logits (the reference's pin is 2e-2,
# tests/test_arch_smoke.py, set on 2-layer configs in bf16).  Limits from
# readings on H100 80GB HBM3 at 700 W (PERF.md):
# * float32 (this phase's own prints): sound runs differ by at most 1.7e-5,
#   bf16 rounding by ~3e-2, so 1e-3 holds the kernels to float32 agreement
#   at full depth.
# * bf16 (scripts/torch_serve_drift.py, which puts in the faults below):
#   prefill is bit-equal to forward in sound runs (the same kernels on
#   the same rows); attention that sees one key past the causal frontier
#   gives 0.042, plain attention's other summation order 0.038.  In
#   decode, at 40-48 layers decode and forward round the residual
#   stream at other points (decode's GEMMs have 2 rows, forward's hundreds);
#   sound runs drift 0.028-0.030 (qwen3-14b) and 0.077-0.086 (mamba2-1.3b),
#   the same with the kernels swapped for their plain versions; on the
#   weights drawn from threefry keys (PR 19) qwen3-14b's sound runs drift
#   0.029 (seed 0) and 0.035 (seed 11, this phase's), its plain version
#   0.036, and the RoPE fault below 0.053.  Known
#   faults give 0.053 (qwen3-14b, decode RoPE one position off), 0.29
#   (un-rotated keys in the cache), 0.27 (mamba2-1.3b, scan decay doubled)
#   and 3.7 (conv tail one token early).
SELF_TOL_F32 = {"prefill": 1e-3, "decode": 1e-3}
SELF_TOL_BF16 = {"qwen3-14b": {"prefill": 1e-2, "decode": 0.04},
                 "mamba2-1.3b": {"prefill": 1e-2, "decode": 0.13}}
# Phase 11: the serving main path at full width, cut in depth to 16 tokens.
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 16

# Phase 13 (a): threefry known answers, taken from jax.random (jax 0.9.0,
# jax_threefry_partitionable on, the CPU): bits and uniforms bit-equal;
# normals (bits of float32) within NORMAL_ULP, the limit
# tests/test_torch_rng.py holds the port's CPU draws to (its erf_inv copy
# differs from XLA's only through XLA's CPU sqrt).
THREEFRY_KNOWN = {
    "bits(PRNGKey(0), (3,))": [4070199207, 4202968722, 1427181096],
    "fold_in(PRNGKey(0), 1)": [928981903, 3453687069],
    "uniform(PRNGKey(0), (3,))": [0x3F729A4E, 0x3F7A8436, 0x3EAA221C],
    "fold_in(PRNGKey(2**31 + 5), 1003)": [3167001686, 3653731380],
    "bits(fold_in(PRNGKey(2**31 + 5), 1003), (5,))": [
        2393393944, 2147669883, 224712787, 4245617430, 382588602],
    "split(PRNGKey(7), 3)": [[3625411723, 1954958720],
                             [195045567, 4062205631],
                             [966301609, 1948237315]],
    "normal(fold_in(fold_in(PRNGKey(2), 1000), 0), (8,))": [
        0xBF3D1C8A, 0x3F804BD0, 0xBE901054, 0xBE8A1423, 0x3FB37253,
        0x3F06A935, 0x3F4066CC, 0x3EE55FF2],
}
NORMAL_ULP = 2
# Phase 13 (b): the grid engine at the paper's per-trial width (FLConfig():
# N = 100, 30 a round, 290 samples, 4 local epochs of batch 32, Adam 1e-3,
# fedavg), the seven cases x three strategies x one seed, cut to 2 rounds.
GRID_STRATEGIES = ("random", "labelwise", "kl")
GRID_ROUNDS = 2
# The 21 trials fit the card in one training call; the grid is run again
# with its training forced into chunks of GRID_CHUNK trials, as a card short
# of memory would split it, and every trajectory must be bit-equal.
GRID_CHUNK = 7
# Phase 13 (c): three trials of a TF32-off grid against the host loop on the
# card.  Selections are bit-equal by construction (the same keys and score
# rounding).  The grid trains 9 trials' clients in one vmap where the host
# loop trains 30, so the parameters could differ by the training kernels'
# summation order; they are held as phase 5 holds card against CPU, the
# update gap within ADAM_REL of the update's norm.  Measured (H100 80GB
# HBM3, 700 W): the parameters bit-equal, the eval loss within 4.7e-7
# relative (the eval runs 9 models in one vmap against 1).  The loss is
# held to GRID_LOSS_REL, 20x that, and the accuracy to GRID_ACC_ATOL, half
# of one of the 500 eval samples, so a flipped sample fails.
GRID_LOSS_REL = 1e-5
GRID_ACC_ATOL = 1e-3
# Phase 14: the clustered family of the paper's claim at the widest cluster
# count the card run exercises, and the attack the robust grid runs (a
# quarter of the clients byzantine, sign-flipped and amplified 4x, and
# training from the previous round's global).  The trimmed mean sums the
# sorted slots left to right on both sides, so the card is held to the
# CPU's bits up to TRIM_ULP (it is bit-equal when nothing else differs).
CLUSTERED = "clustered_fedavg4"
ROBUST = ("median", "trimmed_mean", "krum")
ATTACK = {"frac": 0.25, "behaviors": ["poison", "stale_update"],
          "scale": -4.0, "tau": 1}
TRIM_ULP = 1
# Phase 15: the population engines.  (a)–(b) at the paper's per-trial width
# (FLConfig(): N = 100 in 10 blocks of 10, 30 a round, 290 samples, 4 local
# epochs of batch 32, Adam), case1b × POP_STRATEGIES × one seed, 2 rounds;
# async with buffer_k 10, tau_max 2, α 0.5 under availability(0.3), so that
# the blocks' dark fractions give nonzero delays.  hier ≡ sim and the
# degenerate async (tau_max 0, K = E, ``full``) ≡ sim are held to the
# reference's own 1e-5 pin (tests/test_population.py), TF32 off.  (c) the
# reference benchmark's sweep (benchmarks/population.py): blocks of 256,
# 32 selected a round, 8 samples a client, SGD, batch 8, 1 local epoch, the
# procedural plan, one round at each N; at POP_CHECK_N the round is held
# bit-equal (ids, live flags, scores, statistics) to the CPU and to a
# chunking of POP_CHUNK_ALT blocks.
POP_STRATEGIES = ("labelwise", "random")
POP_ROUNDS = 2
POP_ASYNC = {"buffer_k": 10, "tau_max": 2, "alpha": 0.5}
POP_PIN = 1e-5
POP_BLOCK, POP_BUDGET, POP_SPC = 256, 32, 8
POP_NS = (1 << 10, 1 << 13, 1 << 17, 1 << 20)
POP_CHECK_N = 1 << 13
POP_CHUNK_ALT = 5


def say(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, trials: int = 15) -> float:
    """Device time of one ``fn()`` call: the median over ``trials`` of the
    CUDA-event time of ``reps`` back-to-back calls, divided by ``reps``.

    A spin kernel, twice as long as the host takes to enqueue the calls, runs
    before each trial, so the calls meet a busy card and run back to back:
    the events then time the device, not the host's launch overhead.  The
    inputs stay warm in the 50 MB L2 cache, as in the round, where they were
    written just before."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spin_cycles = int(2 * (time.perf_counter() - t0) * SPIN_HZ)
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def time_cold_ms(fn, inputs, trials: int = 15) -> float:
    """``time_ms`` of ``fn(*args)`` with each call on the next of the
    distinct ``inputs`` in turn.  When together they exceed the 50 MB L2
    cache, a call finds its inputs evicted by the calls since their last
    use, and reads them from device memory."""
    turn = itertools.cycle(inputs)
    return time_ms(lambda: fn(*next(turn)), reps=2 * len(inputs),
                   trials=trials)


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over ``ops_per_s`` (float32 on CUDA cores by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paper_round_inputs(np, cfg, seed: int):
    """Round 0 of a case1b plan at paper width and NumPy-made images around
    the dataset's class templates: (images, labels, valid) arrays."""
    from repro_torch.core import case_label_plan
    from repro_torch.data.synthetic import image_templates
    labels = case_label_plan("case1b", seed, 1, cfg.num_clients)[0]
    templates = image_templates(10, 28, 1, 1234)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(labels.shape + (28, 28, 1), dtype=np.float32)
    images = templates[labels] + np.float32(0.35) * noise
    return images, labels, labels >= 0


def _tree_to(tree, device):
    """A copy of a nested dict/list of tensors (params or caches) on
    ``device``: caches are updated in place, so snapshots must copy."""
    import torch
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device, copy=True) if torch.is_tensor(tree) else tree


def _assert_close(what: str, got, want, tol: float) -> float:
    """max |got - want|; raises unless |got - want| <= tol·(1 + |want|)."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    if bool((err > tol * (1 + want.abs())).any()):
        raise AssertionError(f"{what}: max |diff| {err.max().item():.3e} over "
                             f"the tolerance {tol} (1 + |want|)")
    return err.max().item()


# Kernels that must run on the tensor cores: name in the SASS, the
# instruction that shows it, and the template arguments printed beside it.
TENSOR_CORE_KERNELS = (("flash_attention_wgmma", "HGMMA", ("D",)),
                       ("flash_bwd_dq_wgmma", "HGMMA", ("D",)),
                       ("flash_bwd_dkv_wgmma", "HGMMA", ("D",)),
                       ("ssd_chunk_kernel", "HGMMA", ("NP", "HPB")),
                       ("ssd_prep_kernel", "HMMA", ("NP",)))


def tensor_core_report(lib: Path) -> None:
    """For each instantiation of ``TENSOR_CORE_KERNELS``: its tensor-core
    instructions in the SASS, registers and spills from the ``-Xptxas -v``
    log.  Raises unless every instantiation has them and spills nothing."""
    import re
    from repro_torch.kernels.build import cuda_tool
    ptxas, name = {}, None
    for line in Path(str(lib) + ".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w]+)'?", line)
        if m:
            name = m.group(1)
            continue
        if name:
            entry = ptxas.setdefault(name, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    lines, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            lines[name] = []
        elif name:
            lines[name].append(line)
    for kernel, instr, args in TENSOR_CORE_KERNELS:
        names = sorted(n for n in lines if kernel in n)
        if not names or names != sorted(n for n in ptxas if kernel in n):
            raise AssertionError(f"{kernel}: SASS functions {names} do not "
                                 f"match the ptxas log's")
        for n in names:
            count = sum(line.count(instr) for line in lines[n])
            info = ptxas[n]
            vals = re.findall(r"Li(\d+)E", n)
            targs = ", ".join(f"{a}={v}" for a, v in zip(args, vals))
            say(f"{kernel}<{targs}>: {count} {instr} "
                f"instructions, {info.get('registers')} registers, "
                f"{info.get('spill_bytes')} bytes of spill stores and loads")
            if count == 0 or info.get("spill_bytes") != 0:
                raise AssertionError(f"{n}: no {instr} in its SASS or spills "
                                     f"({info})")


# label_hist's shapes beyond the FL round's (B=100, n=290, C=10): the batched
# grid's histograms in one call (BENCH_sim_grid.json's 7 cases x 3 strategies
# x 5 seeds = 105 trials of 100 clients, 290 labels each), many classes, and
# few long rows.
HIST_GRID = (10500, 290, 10)
HIST_CLASSES = (1000, 4096, 62)
HIST_LONG = (8, 1 << 20, 10)
# Inputs a cold timing rotates through, in bytes at least (2.5x the L2).
COLD_BYTES = 125e6


def hist_inputs(dev, b: int, n: int, c: int, seed: int):
    """Labels in [-3, C + 3) (out of range too) and valid with p = 0.9."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    labels = torch.from_numpy(
        rng.integers(-3, c + 3, (b, n)).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random((b, n)) > 0.1).to(dev)
    return labels, valid


def hist_cases(dev):
    """(what, labels, valid, C) for phase 3: the three shapes of the round,
    the grid, long rows and the kernel's edges."""
    import torch
    cases = [(str(shape), *hist_inputs(dev, *shape, seed=sum(shape)),
              shape[2])
             for shape in [(100, 290, 10), (7, 33, 5), HIST_CLASSES,
                           HIST_GRID, HIST_LONG,
                           (64, 1000, 1), (64, 1000, 33),   # C either side of 32
                           (5, 0, 10), (9, 1, 10), (9, 31, 10),
                           (200, 8192, 10), (1000, 4096, 10),  # rows of 8, 4 warps
                           (4, 300000, 40), (3, 40000, 10),   # split rows
                           (4400, 100, 16), (4400, 100, 17)]]  # many rows
    # Rows that start off a 16-byte boundary: a view one row into a larger
    # tensor (labels and valid in one phase, and labels alone, which sends
    # every sample down the scalar path).
    big_l, big_v = hist_inputs(dev, 6, 4097, 10, seed=4097)
    _, own_v = hist_inputs(dev, 5, 4097, 10, seed=4098)
    cases.append(("(5, 4097, 10) at a row offset", big_l[1:], big_v[1:], 10))
    cases.append(("(5, 4097, 10), labels alone at a row offset", big_l[1:],
                  own_v, 10))
    # The same with many short rows of odd length (C = 16).
    big_l, big_v = hist_inputs(dev, 4500, 33, 16, seed=4500)
    _, own_v = hist_inputs(dev, 4499, 33, 16, seed=4499)
    cases.append(("(4499, 33, 16) at a row offset", big_l[1:], big_v[1:], 16))
    cases.append(("(4499, 33, 16), labels alone at a row offset", big_l[1:],
                  own_v, 16))
    # All-invalid rows, and labels only -1 or C.
    labels, valid = hist_inputs(dev, 50, 290, 10, seed=50)
    valid[::3] = False
    cases.append(("(50, 290, 10) every third row invalid", labels, valid, 10))
    edge = torch.where(labels > 4, 10, -1).to(torch.int32)
    cases.append(("(50, 290, 10) labels -1 and C only", edge, valid, 10))
    return cases


def label_hist_times(dev, kernel, main) -> dict:
    """``kernel`` (label_hist_kernel) timed beside the launch floor, at the
    FL round's inputs ``main`` = (labels, valid, C), and at the grid, many
    classes and long rows shapes, each beside its bound: cold on rotating
    copies (and warm at the grid), with torch.bincount at the grid."""
    import torch

    def bytes_and_ops(labels, valid, c):
        counted = float((valid & (labels >= 0) & (labels < c)).sum().item())
        b, n = labels.shape
        return b * n * (4 + 1) + b * c * 4, counted

    def bincount_ms(labels, valid, c):
        b = labels.shape[0]
        ok = valid & (labels >= 0) & (labels < c)
        flat = torch.arange(b, device=dev)[:, None] * c + labels.long()
        flat = torch.where(ok, flat, b * c).reshape(-1)
        return time_ms(lambda: torch.bincount(flat, minlength=b * c + 1))

    res = {"floor_ms": time_ms(lambda: torch.cuda._sleep(0)),
           "main_ms": time_ms(lambda: kernel(*main))}
    for name, (b, n, c) in (("grid", HIST_GRID), ("classes", HIST_CLASSES),
                            ("long", HIST_LONG)):
        copies = max(8, math.ceil(COLD_BYTES / (b * n * 5)))
        inputs = [hist_inputs(dev, b, n, c, seed=i) + (c,)
                  for i in range(copies)]
        entry = {"shape": (b, n, c), "copies": copies,
                 "cold_ms": time_cold_ms(kernel, inputs)}
        entry["bound_ms"], entry["by"] = bound(*bytes_and_ops(*inputs[0]))
        entry["mb"] = b * n * 5 / 1e6
        if name == "grid":
            entry["warm_ms"] = time_ms(lambda: kernel(*inputs[0]))
            entry["bincount_ms"] = bincount_ms(*inputs[0])
        res[name] = entry
        del inputs
    return res


def say_label_hist_times(t: dict) -> None:
    say(f"launch floor, torch.cuda._sleep(0) timed the same way: "
        f"{t['floor_ms']:.4f} ms")
    say(f"label_hist at the round's shape: kernel {t['main_ms']:.4f} ms, "
        f"{t['main_ms'] - t['floor_ms']:.4f} ms over the floor")
    for name, what in (("grid", "the grid's histograms in one call"),
                       ("classes", "many classes"), ("long", "long rows")):
        e = t[name]
        line = (f"label_hist {tuple(e['shape'])}, {what}: cold "
                f"{e['cold_ms']:.4f} ms over {e['copies']} copies "
                f"({e['mb']:.1f} MB each), bound {e['bound_ms']:.4f} ms "
                f"({e['by']}), {e['bound_ms'] / e['cold_ms']:.0%} of it")
        if name == "grid":
            line += (f"; warm {e['warm_ms']:.4f} ms; torch.bincount "
                     f"{e['bincount_ms']:.4f} ms")
        say(line)


def phase8_flash(dev) -> float:
    """flash_attention against its plain version; returns the max abs error."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     gqa_attention_ref,
                                                     gqa_flash_attention)
    say("== 8. flash_attention against its plain version")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain versions
    g = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    cases = [((160, 1024, 128), torch.bfloat16, True, 0),
             ((160, 1024, 128), torch.bfloat16, True, 256),
             ((8, 77, 64), torch.float32, True, 0),
             ((8, 77, 64), torch.bfloat16, True, 0),
             ((8, 1000, 128), torch.bfloat16, True, 0),
             ((8, 1000, 128), torch.bfloat16, True, 256),
             ((8, 77, 64), torch.bfloat16, False, 0),
             ((8, 1000, 128), torch.bfloat16, False, 0)]
    for shape, dtype, causal, window in cases:
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        got = flash_attention(q, k, v, causal=causal, window=window).float()
        want = attention_ref(q, k, v, causal, window).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        tol = (FLASH_F32_TOL * (1 + want.abs()) if dtype == torch.float32
               else 2.0 ** -7 * want.abs() + 1e-5)
        if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {shape} {dtype} causal="
                                 f"{causal} window={window}: max |diff| "
                                 f"{err.max().item()}")
        worst = max(worst, err.max().item())
        say(f"flash_attention {shape} {dtype} causal={causal} window={window}"
            f": max abs err {err.max().item():.3e}")
    for b, s, h, kvh, d in [(4, 1024, 40, 8, 128), (2, 333, 40, 8, 128)]:
        q = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, s, kvh, d), generator=g,
                            device=dev).bfloat16() for _ in range(2))
        got = gqa_flash_attention(q, k, v).float()
        want = gqa_attention_ref(q, k, v).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        if bool((err > 2.0 ** -7 * want.abs() + 1e-5).any()) \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"gqa_flash_attention {(b, s, h, d)}: max "
                                 f"|diff| {err.max().item()}")
        worst = max(worst, err.max().item())
        say(f"gqa_flash_attention {(b, s, h, d)} x {(b, s, kvh, d)} bf16: "
            f"max abs err {err.max().item():.3e}")
    return worst


def _ssd_inputs(dev, b, s, h, p, g_, n, seed, decaying=False):
    """x, dt, A, B, C as the model draws them; ``decaying``: dt uniform in
    [0, 10) and A near -10, so the log-decay summed over one of the kernel's
    chunks reaches thousands."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rn(b, s, h, p)
    if decaying:
        dt = 10 * torch.rand((b, s, h), generator=gen, device=dev)
        A = -10 * torch.exp(0.1 * rn(h))
    else:
        dt, A = torch.nn.functional.softplus(rn(b, s, h)), -torch.exp(0.3 * rn(h))
    return x, dt, A, 0.5 * rn(b, s, g_, n), 0.5 * rn(b, s, g_, n)


def phase9_ssd(dev) -> float:
    """ssd_apply against its plain version; returns the max abs error."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_apply, ssd_apply_ref
    say("== 9. ssd_scan against its plain version")
    worst = 0.0
    for b, s, h, p, g_, n, chunk, decaying in [
            (4, 1024, 64, 64, 1, 128, 128, False),
            (2, 96, 16, 32, 1, 32, 32, False),
            (2, 64, 4, 8, 2, 64, 16, False),
            (1, 2048, 4, 64, 1, 128, 128, True)]:
        args = _ssd_inputs(dev, b, s, h, p, g_, n, seed=s + h,
                           decaying=decaying)
        y, fin = ssd_apply(*args, chunk=chunk)
        y_ref, fin_ref = ssd_apply_ref(*args)
        torch.cuda.synchronize()
        what = (f"ssd_apply (b={b}, S={s}, H={h}, P={p}, G={g_}, N={n}"
                f"{', strongly decaying' if decaying else ''})")
        err = max(_assert_close(what + " y", y, y_ref, SSD_TOL),
                  _assert_close(what + " state", fin, fin_ref, SSD_TOL))
        worst = max(worst, err)
        say(f"{what}: max abs err {err:.3e} (|y| up to "
            f"{y_ref.abs().max().item():.1f})")
    return worst


def phase10_serve_card_vs_cpu(dev) -> None:
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import decode_step, init_model, prefill
    from repro_torch.rng import PRNGKey
    say("== 10. serving at reduced size, card against CPU (float32, TF32 off)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompt, gen = 40, 5            # 40: no multiple of the SSD chunk (32)
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced(dtype="float32")
        params = init_model(PRNGKey(10), cfg, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(10).integers(
            0, cfg.vocab_size, (2, prompt + gen)))
        runs = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            p = _tree_to(params, d)
            t = toks.to(d)
            kernels.reset_launch_counts()
            with torch.inference_mode():
                logits, caches = prefill(p, cfg, {"tokens": t[:, :prompt]},
                                         prompt + gen)
                steps = [logits]
                snap = [_tree_to(caches, "cpu")]
                for i in range(prompt, prompt + gen):
                    logits, caches = decode_step(p, cfg, t[:, i], caches)
                    steps.append(logits)
                snap.append(_tree_to(caches, "cpu"))
            counts = kernels.launch_counts()
            runs[side] = ([x.cpu() for x in steps], snap, counts)
        kernel = "flash_attention" if arch == "qwen3-14b" else "ssd_scan"
        if runs["card"][2][kernel] != cfg.num_layers:
            raise AssertionError(f"{arch}: {runs['card'][2]} launches on the "
                                 f"card, expected {cfg.num_layers} {kernel}")
        (s_gpu, c_gpu, _), (s_cpu, c_cpu, _) = runs["card"], runs["cpu"]
        gaps = [_assert_close(f"{arch} logits step {i}", a, b, SERVE_TOL)
                for i, (a, b) in enumerate(zip(s_gpu, s_cpu))]
        cache_gap = 0.0
        for when, (cg, cc) in enumerate(zip(c_gpu, c_cpu)):
            for layer, (lg, lc) in enumerate(zip(cg, cc)):
                for key in lc:
                    if key == "idx":
                        if lg[key] != lc[key]:
                            raise AssertionError(f"{arch} cache idx differs")
                        continue
                    cache_gap = max(cache_gap, _assert_close(
                        f"{arch} cache {key} layer {layer} ({when})",
                        lg[key], lc[key], SERVE_TOL))
        say(f"{arch} reduced: prefill logits max |card - cpu| {gaps[0]:.3e}, "
            f"{gen} decode steps up to {max(gaps[1:]):.3e}, caches up to "
            f"{cache_gap:.3e}; card launches {runs['card'][2]}")


def serve_gaps(params, cfg, toks) -> dict:
    """``forward`` on toks (B, n + 1), ``prefill`` on the first n tokens and
    one ``decode_step`` on token n.  Returns each call's kernel launches,
    whether its logits are finite, |forward|'s max (``scale``) and the
    max |diff| of prefill against forward at position n - 1 and of the
    decode step against forward at n: absolute (``prefill``, ``decode``) and
    relative to 1 + |forward| (``prefill_rel``, ``decode_rel``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import decode_step, forward, prefill
    n = toks.shape[1] - 1
    calls, finite = {}, {}
    with torch.inference_mode():
        kernels.reset_launch_counts()
        full, _ = forward(params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        calls["forward"] = kernels.launch_counts()
        kernels.reset_launch_counts()
        last, caches = prefill(params, cfg, {"tokens": toks[:, :n]}, n + 8)
        torch.cuda.synchronize()
        calls["prefill"] = kernels.launch_counts()
        kernels.reset_launch_counts()
        step, _ = decode_step(params, cfg, toks[:, n], caches)
        torch.cuda.synchronize()
        calls["decode_step"] = kernels.launch_counts()
    for name, x in (("forward", full), ("prefill", last),
                    ("decode_step", step)):
        finite[name] = bool(torch.isfinite(x).all())
    full = full.float()
    out = {"launches": calls, "finite": finite,
           "scale": full.abs().max().item()}
    for name, got, want in (("prefill", last, full[:, n - 1]),
                            ("decode", step, full[:, n])):
        err = (got.float() - want).abs()
        out[name] = err.max().item()
        out[name + "_rel"] = (err / (1 + want.abs())).max().item()
    return out


def self_consistency_inputs(dev, cfg):
    """Full-width weights of ``cfg`` (seed 11) and tokens (2, 201) (seed 11;
    a prompt of 200, no multiple of the SSD chunk)."""
    import numpy as np
    import torch
    from repro_torch.models import init_model
    from repro_torch.rng import PRNGKey
    params = init_model(PRNGKey(11, dev), cfg, device=dev)
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 201))).to(dev)
    return params, toks


def self_consistency(dev, cfg, kernel: str) -> dict:
    """``serve_gaps`` on ``self_consistency_inputs``; asserts one ``kernel``
    launch per layer in forward and prefill, no launch in decode, and finite
    logits."""
    import gc
    import torch
    params, toks = self_consistency_inputs(dev, cfg)
    out = serve_gaps(params, cfg, toks)
    calls = {"forward": out["launches"]["forward"][kernel],
             "prefill": out["launches"]["prefill"][kernel],
             "decode_step": sum(out["launches"]["decode_step"].values())}
    if calls != {"forward": cfg.num_layers, "prefill": cfg.num_layers,
                 "decode_step": 0}:
        raise AssertionError(f"{cfg.name}: launches per call {calls}")
    for name, ok in out["finite"].items():
        if not ok:
            raise AssertionError(f"{cfg.name}: non-finite {name} logits")
    out["launches"] = calls
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase11_serve(dev) -> dict:
    """The serving main path at full width; returns per-arch results."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serve
    say("== 11. main path: run_serve at full width on the card")
    out = {}
    for arch, kernel in (("qwen3-14b", "flash_attention"),
                         ("mamba2-1.3b", "ssd_scan")):
        cfg = get_config(arch)
        want = {k: 0 for k in kernels.launch_counts()}
        want[kernel] = cfg.num_layers
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        seqs, t_prefill, t_decode = run_serve(
            arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
            reduced=False, device=dev)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        if launches != want:
            raise AssertionError(f"{arch}: launches {launches}, expected "
                                 f"{want} (one per layer of the prefill)")
        if seqs.shape != (SERVE_BATCH, SERVE_GEN) or int(seqs.min()) < 0 \
                or int(seqs.max()) >= cfg.vocab_size:
            raise AssertionError(f"{arch}: tokens {tuple(seqs.shape)} out of "
                                 f"range")
        say(f"{arch}: run_serve(batch={SERVE_BATCH}, prompt_len="
            f"{SERVE_PROMPT}, gen={SERVE_GEN}, reduced=False): prefill "
            f"{t_prefill * 1e3:.1f} ms, decode {t_decode * 1e3:.2f} "
            f"ms/token, launches {launches}, first tokens "
            f"{seqs[0, :6].tolist()}")
        del seqs
        gc.collect()
        torch.cuda.empty_cache()

        for dtype in ("bfloat16", "float32"):
            gaps = self_consistency(dev, dataclasses.replace(cfg, dtype=dtype),
                                    kernel)
            tol = SELF_TOL_F32 if dtype == "float32" else SELF_TOL_BF16[arch]
            say(f"{arch} {dtype}: {kernel} launches per call "
                f"{gaps['launches']}; prefill ≡ forward max |diff| "
                f"{gaps['prefill']:.3e} (relative {gaps['prefill_rel']:.3e},"
                f" limit {tol['prefill']}), decode_step ≡ forward "
                f"{gaps['decode']:.3e} (relative {gaps['decode_rel']:.3e}, "
                f"limit {tol['decode']}); |logits| up to "
                f"{gaps['scale']:.2f}")
            for name in ("prefill", "decode"):
                if not gaps[name + "_rel"] <= tol[name]:
                    raise AssertionError(
                        f"{arch} {dtype}: {name} vs forward differs by "
                        f"{gaps[name]} (relative {gaps[name + '_rel']}) "
                        f"over {tol[name]}")
        out[arch] = {"launches": launches[kernel], "t_prefill": t_prefill,
                     "t_decode": t_decode}
    return out


def flash_mma_flops(b: int, s: int, h: int, d: int) -> int:
    """Tensor-core operations the bf16 flash kernel runs for causal
    attention: each 64-row warpgroup of a 128-row q-tile runs every 64-key
    tile up to its frontier, Q.K^T once and P.V twice (P_hi and P_lo).  For
    information only: the bound counts live (q, k) pairs and each product
    once."""
    tiles = 0
    for q0 in range(0, s, 128):
        t_hi = -(-min(s, q0 + 128) // 64)
        for row_lo in (q0, q0 + 64):
            tiles += min(t_hi, (row_lo + 63) // 64 + 1)
    return b * h * tiles * 3 * 2 * 64 * 64 * d


def flash_bwd_mma_flops(b: int, s: int, h: int, d: int) -> int:
    """Tensor-core operations the bf16 backward kernels run for causal
    attention: dQ a 64-row warpgroup of a 128-row q-tile over every 64-key
    tile up to its frontier (S, dP once, dS.K twice); dK/dV a 64-key
    warpgroup of a 128-key tile over every 64-row q-tile from its diagonal,
    for each q-head of its group (S^T, dP^T once, P^T.dO and dS^T.Q
    twice).  For information only: the bound counts live (q, k)
    pairs and each product once."""
    dq_tiles = dkv_tiles = 0
    for q0 in range(0, s, 128):
        t_hi = -(-min(s, q0 + 128) // 64)
        for row_lo in (q0, q0 + 64):
            if row_lo < s:
                dq_tiles += min(t_hi, (row_lo + 63) // 64 + 1)
    for k0 in range(0, s, 128):
        for kw0 in (k0, k0 + 64):
            if kw0 < s:
                dkv_tiles += sum(1 for q0 in range(k0 // 64 * 64, s, 64)
                                 if q0 + 63 >= kw0)
    per = 2 * 64 * 64 * d
    return b * h * (dq_tiles * 4 + dkv_tiles * 6) * per


def ssd_mma_flops(b: int, s: int, h: int, p: int, g_: int, n: int) -> int:
    """Tensor-core operations the SSD kernels run (csrc/ssd_scan.cu), each
    product three times for the split TF32 (hi.hi, hi.lo, lo.hi), N padded
    to 16/32/64/128 and P to 64 rows a head, over chunks of 32 steps: C.B^T
    once per (b, chunk, group); per head and chunk S_in.C^T (from the second
    chunk on), M.X and the state update.  For information only: the bound
    counts the chunked form's products once."""
    np_ = next(w for w in (16, 32, 64, 128) if n <= w)
    chunks, heads = -(-s // 32), b * h * -(-p // 64)
    per_head = 3 * 2 * 64 * 8 * (
        (chunks - 1) * (np_ // 8) * 32 + chunks * 4 * (32 + np_))
    prep = 3 * 2 * 32 * 32 * np_ * b * chunks * g_
    return heads * per_head + prep


def phase12_times(dev) -> dict:
    """flash_attention and ssd_scan at the serving path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import gqa_attention_ref
    from repro_torch.kernels.flash_attention.flash_attention import launch
    from repro_torch.kernels.ssd_scan import ssd_apply, ssd_apply_ref
    say("== 12. flash_attention and ssd_scan at the serving path's shapes")
    g = torch.Generator(device=dev).manual_seed(12)
    b, s, h, kvh, d = SERVE_BATCH, SERVE_PROMPT, 40, 8, 128
    q = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((b, s, kvh, d), generator=g, device=dev).bfloat16()
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def serving():                # what prefill runs: no row statistics
        return launch(q, k, v, causal=True, window=0)

    def training():               # what a train step runs: L written too
        return launch(q, k, v, causal=True, window=0, with_lse=True)

    if not torch.equal(serving(), training()[0]):
        raise AssertionError("flash_attention: the output with lse differs "
                             "from the output without")
    turns = [time_ms(f) for f in (serving, training, training, serving)]
    fa = {"ms": (turns[0] + turns[3]) / 2, "lse_ms": (turns[1] + turns[2]) / 2,
          "plain": time_ms(lambda: gqa_attention_ref(q, k, v), reps=3,
                           trials=5),
          "lib": time_ms(lambda: F.scaled_dot_product_attention(
              qt, kt, vt, is_causal=True, enable_gqa=True))}
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    ops = 4 * b * h * d * s * (s + 1) // 2     # live (q, k) pairs, QK and PV
    fa["bound"], fa["by"] = bound(nbytes, ops, BF16_OPS_PER_S)
    say(f"flash_attention (B={b}, S={s}, H={h}, KV={kvh}, D={d}, bf16, "
        f"causal): kernel {fa['ms']:.4f} ms, bound {fa['bound']:.4f} ms "
        f"({fa['by']}: {ops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16, "
        f"{nbytes / 1e6:.1f} MB), plain {fa['plain']:.4f} ms, "
        f"scaled_dot_product_attention {fa['lib']:.4f} ms")
    say(f"flash_attention writing each row's logsumexp for the backward: "
        f"{fa['lse_ms']:.4f} ms against {fa['ms']:.4f} ms without "
        f"({fa['lse_ms'] / fa['ms'] - 1:+.2%}; in turns "
        f"{', '.join(f'{x:.4f}' for x in turns)}), output bit-identical")
    mma = flash_mma_flops(b, s, h, d)
    say(f"flash_attention bf16 kernel's own tensor-core work: {mma / 1e9:.1f} "
        f"GFLOP (Q.K^T once, P.V twice for the P_hi/P_lo split, whole "
        f"diagonal tiles), {mma / (fa['ms'] * 1e-3) / 1e12:.0f} TFLOP/s "
        f"achieved")

    b, s, h, p, g_, n = SERVE_BATCH, SERVE_PROMPT, 64, 64, 1, 128
    chunk = 128                               # mamba2-1.3b's ssm_chunk
    args = _ssd_inputs(dev, b, s, h, p, g_, n, seed=12)
    ssd = {"ms": time_ms(lambda: ssd_apply(*args, chunk=chunk)),
           "plain": time_ms(lambda: ssd_apply_ref(*args), reps=1, trials=3),
           "lib": None}
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g_ * n
                  + b * h * p * n)
    # The chunked form's products done once: per head and chunk C.B^T is
    # shared by the group, then (C.B^T o L).X, C.S_in^T and X^T.B.
    ops = 2 * b * s * (g_ * chunk * n + h * p * (chunk + 2 * n))
    ssd["bound"], ssd["by"] = bound(nbytes, ops, TF32_OPS_PER_S)
    recurrence = 5 * b * s * h * p * n / F32_OPS_PER_S * 1e3
    say(f"ssd_scan (b={b}, S={s}, H={h}, P={p}, G={g_}, N={n}, f32): kernel "
        f"{ssd['ms']:.4f} ms, bound {ssd['bound']:.4f} ms ({ssd['by']}: "
        f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; the chunked form's products "
        f"at chunk {chunk}, {ops / 1e9:.2f} GFLOP, take "
        f"{ops / TF32_OPS_PER_S * 1e3:.4f} ms at 495 TFLOP/s TF32), plain "
        f"{ssd['plain']:.4f} ms; no single PyTorch call computes the SSD "
        f"scan, so there is no library time")
    say(f"ssd_scan, the plain recurrence's float32 arithmetic (5 flops per "
        f"(t, p, n) at 67 TFLOP/s, the bound the recurrence kernel had): "
        f"{recurrence:.4f} ms")
    mma = ssd_mma_flops(b, s, h, p, g_, n)
    say(f"ssd_scan kernels' own tensor-core work: {mma / 1e9:.1f} GFLOP "
        f"(split TF32, each product three times), "
        f"{mma / (ssd['ms'] * 1e-3) / 1e12:.0f} TFLOP/s achieved")
    return {"flash_attention": fa, "ssd_scan": ssd}


def _ulp_gap(a, b):
    """|a − b| in float32 ulps, through the sign-magnitude order of the bit
    patterns (so values either side of 0 compare too)."""
    import torch

    def order(x):
        i = x.float().cpu().contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (order(a) - order(b)).abs()


def phase13a_threefry(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch import rng
    say("== 13a. threefry on the card: JAX's known answers, and the CPU's "
        "draws")
    k0 = rng.PRNGKey(0, dev)
    kb = rng.fold_in(rng.PRNGKey(2 ** 31 + 5, dev), 1003)
    got = {
        "bits(PRNGKey(0), (3,))": rng.random_bits(k0, (3,)),
        "fold_in(PRNGKey(0), 1)": rng.fold_in(k0, 1),
        "uniform(PRNGKey(0), (3,))": (
            rng.uniform(k0, (3,)).view(torch.int32).to(torch.int64)
            & 0xFFFFFFFF),
        "fold_in(PRNGKey(2**31 + 5), 1003)": kb,
        "bits(fold_in(PRNGKey(2**31 + 5), 1003), (5,))": rng.random_bits(
            kb, (5,)),
        "split(PRNGKey(7), 3)": rng.split(rng.PRNGKey(7, dev), 3),
    }
    for name, x in got.items():
        if x.cpu().tolist() != THREEFRY_KNOWN[name]:
            raise AssertionError(f"threefry {name}: {x.cpu().tolist()} on the "
                                 f"card, JAX gives {THREEFRY_KNOWN[name]}")
    name = "normal(fold_in(fold_in(PRNGKey(2), 1000), 0), (8,))"
    want = torch.from_numpy(np.array(THREEFRY_KNOWN[name], np.uint32)
                            .view(np.float32))
    normal = rng.normal(rng.fold_in(rng.fold_in(rng.PRNGKey(2, dev), 1000),
                                    0), (8,))
    known_gap = int(_ulp_gap(normal, want).max())
    if known_gap > NORMAL_ULP:
        raise AssertionError(f"threefry {name}: {known_gap} ulp from JAX's")
    say(f"known answers: {len(got)} key/bit/uniform cases bit-equal; 8 "
        f"normals within {known_gap} ulp of JAX's (limit {NORMAL_ULP})")
    # The same draws on the card and on the CPU (which the CPU tests hold to
    # JAX): 64 keys of many seeds, 16,384 elements each.
    keys = rng.fold_in(rng.PRNGKey(torch.arange(64) * 7919 + 3), 1001)
    shape = (16384,)
    for what in ("random_bits", "uniform"):
        fn = getattr(rng, what)
        if not torch.equal(fn(keys.to(dev), shape).cpu(), fn(keys, shape)):
            raise AssertionError(f"threefry {what}: card differs from CPU")
    gap = _ulp_gap(rng.normal(keys.to(dev), shape), rng.normal(keys, shape))
    share = float((gap > 0).float().mean())
    if int(gap.max()) > NORMAL_ULP:
        raise AssertionError(f"normal: card {int(gap.max())} ulp from CPU")
    say(f"card against CPU, 64 keys x {shape[0]}: bits and uniforms "
        f"bit-equal; normals differ on {share:.3e} of draws, by at most "
        f"{int(gap.max())} ulp (the card's own rounding; limit {NORMAL_ULP})")
    return {"normal_known_ulp": known_gap, "normal_card_ulp": int(gap.max()),
            "normal_card_share": share}


def _grid_spec(**kw):
    from repro_torch.configs import FLConfig
    from repro_torch.core import CASES
    from repro_torch.fl import ExperimentSpec, ScenarioSpec
    return ExperimentSpec(
        scenarios=tuple(ScenarioSpec.from_case(c) for c in CASES),
        strategies=GRID_STRATEGIES, seeds=(0,), engine="sim", fl=FLConfig(),
        rounds=GRID_ROUNDS, **kw)


def phase13b_grid(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.data import ImageDataset
    from repro_torch.fl import run
    spec = _grid_spec()
    cfg = spec.fl
    trials = len(spec.scenarios) * len(spec.strategies) * len(spec.seeds)
    say(f"== 13b. main path: run(ExperimentSpec(engine='sim')), "
        f"{len(spec.scenarios)} cases x {spec.strategies} x 1 seed = "
        f"{trials} trials, {GRID_ROUNDS} rounds, paper width")
    ds = ImageDataset(device=dev)
    # The grid runs as a user's process would, with PyTorch's default TF32
    # settings (cuDNN's convolutions in TF32, matmuls in float32); phases 8
    # and 10 turned both off for the float32 checks after them.
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(spec, ds=ds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    meta = res.meta["sim"]
    if meta["chunk_trials"] != trials:
        raise AssertionError(f"grid: {trials} trials split into chunks of "
                             f"{meta['chunk_trials']}")
    import repro_torch.fl.sim as sim
    chunk_of = sim._chunk_trials
    sim._chunk_trials = lambda device, per_trial, n: GRID_CHUNK
    try:
        chunked = run(spec, ds=ds, device=dev)
    finally:
        sim._chunk_trials = chunk_of
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    if chunked.meta["sim"]["chunk_trials"] != GRID_CHUNK:
        raise AssertionError("grid: the forced chunks did not take")
    for name in ("num_selected", "loss", "accuracy"):
        if not np.array_equal(getattr(chunked, name), getattr(res, name)):
            raise AssertionError(f"grid: {name} trained in chunks of "
                                 f"{GRID_CHUNK} differs from one pass")
    say(f"grid: trained in chunks of {GRID_CHUNK} trials, every trajectory "
        f"bit-equal to the one pass (TF32 as PyTorch's defaults)")
    want = {"label_hist": GRID_ROUNDS, "weighted_agg": GRID_ROUNDS,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "ssd_scan": 0}
    if launches != want:
        raise AssertionError(f"grid launch counts {launches}, expected {want}")
    if not (np.isfinite(res.accuracy).all() and np.isfinite(res.loss).all()):
        raise AssertionError("grid: non-finite trajectory")
    nsel = res.num_selected
    if not np.all((nsel == 0) | (nsel == cfg.clients_per_round)):
        raise AssertionError(f"grid: num_selected {nsel.tolist()}")
    for s in ("random", "kl"):          # every client has data: always 30
        i = spec.strategies.index(s)
        if not np.all(nsel[:, i] == cfg.clients_per_round):
            raise AssertionError(f"grid: {s} selected {nsel[:, i].tolist()}")
    for k, sc in enumerate(res.scenarios):
        say(f"  {sc:8s} final acc " + "  ".join(
            f"{st}={res.accuracy[k, i, 0, -1]:.4f}"
            f" (sel {nsel[k, i, 0].tolist()})"
            for i, st in enumerate(res.strategies)))
    round_s = meta["round_s"]
    say(f"grid: launches {launches}; rounds {[f'{x:.3f}' for x in round_s]} "
        f"s wall ({round_s[-1] / trials * 1e3:.1f} ms a trial in the last "
        f"round); whole run {wall:.2f} s; training chunk "
        f"{meta['chunk_trials']} trials ({meta['per_trial_bytes'] / 1e9:.2f} "
        f"GB a trial); torch.cuda.max_memory_allocated "
        f"{peak / 1e9:.2f} GB")
    return {"launches": launches, "round_s": round_s, "trials": trials,
            "peak_bytes": peak, "wall_s": wall,
            "chunk_trials": meta["chunk_trials"],
            "per_trial_bytes": meta["per_trial_bytes"]}


def _host_trace(plan, cfg, strategy: str, seed: int, ds, rounds: int,
                aggregation=None, poison_scale=None, adv=None):
    """The host loop's rounds, as ``run_fl_host`` runs them, keeping each
    round's histograms, mask, selected clients, a clustered family's
    assignment (else the eval loss and accuracy) and the init and final
    params.  ``poison_scale`` with the (N,) byzantine mask ``adv`` runs the
    poison behavior."""
    import torch
    from repro_torch import rng
    from repro_torch.data import client_batches
    from repro_torch.fl import get_workload, make_fl_round
    from repro_torch.fl.round import (resolve_aggregator,
                                      stack_global_params)
    wl = get_workload("cnn")
    agg = resolve_aggregator(aggregation, cfg)
    key = rng.PRNGKey(seed, ds.device)
    init = params = wl.init(rng.fold_in(key, 1), ds)
    if agg.clustered:
        init = params = stack_global_params(params, agg.n_clusters)
    fl_round = make_fl_round(wl.make_loss(ds), cfg, strategy, agg,
                             poison_scale=poison_scale)
    eval_batch, eval_fn = wl.eval_set(ds, 50), wl.make_eval(ds)
    out = {k: [] for k in ("hists", "mask", "selected", "num_selected",
                           "assign", "loss", "accuracy")}
    for t in range(rounds):
        kt = rng.fold_in(key, 1000 + t)
        data = wl.materialize(ds, plan[t], rng.fold_in(kt, 0))
        batches = client_batches(data, cfg.batch_size, wl.batch_keys)
        params, info = fl_round(params, batches, data["hists"],
                                rng.fold_in(kt, 1), adv)
        for k, v in (("hists", data["hists"]), ("mask", info["mask"]),
                     ("selected", info["selected"].long()),
                     ("num_selected", info["num_selected"]),
                     ("assign", info.get("cluster_assign"))):
            out[k].append(v)
        if not agg.clustered:
            with torch.no_grad():
                loss, m = eval_fn(params, eval_batch)
            out["loss"].append(loss)
            out["accuracy"].append(m["accuracy"])
    return init, params, out


def phase13c_grid_vs_host(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import FLConfig
    from repro_torch.core import case_label_plan
    from repro_torch.data import ImageDataset
    from repro_torch.fl import GridRun, run_fl_host
    say("== 13c. three grid trials against the host loop on the card "
        "(TF32 off)")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FLConfig()
    cases = ("case1b", "case2b", "iid")
    plans = np.stack([case_label_plan(c, 0, GRID_ROUNDS, cfg.num_clients)
                      for c in cases])
    ds = ImageDataset(device=dev)
    grid = GridRun(plans, cfg, strategies=GRID_STRATEGIES, seeds=(0,),
                   rounds=GRID_ROUNDS, ds=ds, device=dev)
    infos = [grid.round(t) for t in range(GRID_ROUNDS)]
    res = grid.result(0.0)
    worst = {"update_rel": 0.0, "loss_rel": 0.0, "acc": 0.0}
    for k in range(3):                   # trial (case k, strategy k, seed 0)
        strategy = GRID_STRATEGIES[k]
        trial = k * len(GRID_STRATEGIES) + k
        init, params, host = _host_trace(plans[k], cfg, strategy, 0, ds,
                                         GRID_ROUNDS)
        for t, info in enumerate(infos):
            for name in ("hists", "mask", "selected"):
                if not torch.equal(info[name][trial], host[name][t]):
                    raise AssertionError(f"grid vs host: {cases[k]}/"
                                         f"{strategy} round {t} {name} differ")
        nsel = [float(x) for x in host["num_selected"]]
        if res.num_selected[k, k, 0].tolist() != nsel:
            raise AssertionError(f"grid vs host: num_selected "
                                 f"{res.num_selected[k, k, 0]} vs {nsel}")
        hist = run_fl_host(plans[k], cfg, strategy=strategy, rounds=GRID_ROUNDS,
                           seed=0, ds=ds, device=dev)
        if hist.loss != [float(x) for x in host["loss"]]:
            raise AssertionError("run_fl_host differs from its own rounds")
        upd = torch.cat([(params[n] - init[n]).reshape(-1) for n in params])
        gap = torch.cat([(grid.params[n][trial] - params[n]).reshape(-1)
                         for n in params])
        rel = float(gap.norm() / upd.norm())
        gap_loss = np.abs(res.loss[k, k, 0] - np.asarray(hist.loss))
        loss_rel = float(np.max(np.where(
            gap_loss == 0, 0.0,
            gap_loss / np.maximum(np.abs(hist.loss), 1e-30))))
        acc = float(np.max(np.abs(res.accuracy[k, k, 0] - hist.accuracy)))
        say(f"  {cases[k]}/{strategy}: histograms, masks, orders, "
            f"num_selected {nsel} bit-equal; |param gap| / |update| "
            f"{rel:.3e}, loss rel {loss_rel:.3e}, accuracy {acc:.4f} "
            f"(grid {res.accuracy[k, k, 0].tolist()}, host {hist.accuracy})")
        worst = {"update_rel": max(worst["update_rel"], rel),
                 "loss_rel": max(worst["loss_rel"], loss_rel),
                 "acc": max(worst["acc"], acc)}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    if not (worst["update_rel"] <= ADAM_REL
            and worst["loss_rel"] <= GRID_LOSS_REL
            and worst["acc"] <= GRID_ACC_ATOL):
        raise AssertionError(f"grid vs host beyond the limits: {worst}")
    return worst


def phase13d_trial_axis(dev) -> dict:
    import math
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.data import ImageDataset
    from repro_torch.fl import GridRun
    from repro_torch.kernels.label_hist import label_hist_kernel, label_hist_ref
    from repro_torch.kernels.weighted_agg import (weighted_agg_leaves,
                                                  weighted_agg_ref)
    from repro_torch.models import cnn_init
    spec = _grid_spec()
    trials = len(spec.scenarios) * len(spec.strategies)
    say(f"== 13d. weighted_agg with the trial axis ({trials} trials) and "
        f"label_hist on the grid engine's inputs")
    sizes = [math.prod(v.shape) for v in cnn_init(device=dev).values()]
    g = np.random.default_rng(13)
    xs = [torch.from_numpy(0.05 * g.standard_normal(
        (trials, K_CLIENTS, n)).astype(np.float32)).to(dev) for n in sizes]
    w = torch.from_numpy((g.uniform(30, 290, (trials, K_CLIENTS))
                          * (g.random((trials, K_CLIENTS)) > 0.2))
                         .astype(np.float32)).to(dev)
    denom = torch.clamp(w.sum(-1), min=1e-12)
    kernels.reset_launch_counts()
    got = weighted_agg_leaves(xs, w, denom)
    torch.cuda.synchronize()
    if kernels.launch_counts()["weighted_agg"] != 1:
        raise AssertionError("weighted_agg: the trial axis took more than one "
                             "launch")
    for t in range(trials):
        one = weighted_agg_leaves([x[t] for x in xs], w[t], denom[t:t + 1])
        if not all(torch.equal(y[t], y1) for y, y1 in zip(got, one)):
            raise AssertionError(f"weighted_agg trial {t}: batched launch "
                                 f"differs from its own launch")
    err = 0.0
    for x, y in zip(xs, got):
        want = weighted_agg_ref(x, w, denom)
        tol = (2 * K_CLIENTS * 2.0 ** -24 * torch.einsum("tk,tkn->tn", w,
                                                           x.abs())
               / denom[:, None] + 2.0 ** -23 * want.abs())
        e = (y - want).abs()
        if bool((e > tol).any()):
            raise AssertionError(f"weighted_agg trial axis: {e.max().item()} "
                                 f"over the float32 bound")
        err = max(err, e.max().item())
    agg = {"ms": time_ms(lambda: weighted_agg_leaves(xs, w, denom)),
           "plain": time_ms(lambda: [weighted_agg_ref(x, w, denom)
                                     for x in xs], reps=2, trials=5),
           "lib": time_ms(lambda: [torch.bmm(w[:, None, :], x) for x in xs]),
           "err": err}
    nbytes = sum(trials * (K_CLIENTS * n + K_CLIENTS + n) * 4 for n in sizes)
    agg["bound"], agg["by"] = bound(nbytes, 2 * trials * K_CLIENTS * sum(sizes))
    say(f"weighted_agg (T={trials}, K={K_CLIENTS}, the CNN's {len(sizes)} "
        f"leaves, {sum(sizes)} columns): bit-equal to {trials} one-trial "
        f"launches, max abs err {err:.3e} against the plain version; kernel "
        f"{agg['ms']:.4f} ms, bound {agg['bound']:.4f} ms ({agg['by']}, "
        f"{nbytes / 1e6:.1f} MB), plain {agg['plain']:.4f} ms, bmm a leaf "
        f"{agg['lib']:.4f} ms")
    # label_hist on the engine's own round-0 inputs: every trial's plan row.
    ds = ImageDataset(device=dev)
    plans = np.stack([s.lower(spec.fl, spec.seeds, GRID_ROUNDS).plan
                      for s in spec.scenarios])
    grid = GridRun(plans, spec.fl, strategies=spec.strategies,
                   seeds=spec.seeds, rounds=GRID_ROUNDS, ds=ds, device=dev)
    lab = grid.plans[grid.plan_idx, 0]
    lab = lab.reshape(-1, lab.shape[-1]).contiguous()
    val = lab >= 0
    lab0 = torch.where(val, lab, 0)
    b, n = lab.shape
    c = 10
    if not torch.equal(label_hist_kernel(lab0, val, c),
                       label_hist_ref(lab0, val, c)):
        raise AssertionError("label_hist differs on the grid's inputs")
    flat = torch.arange(b, device=dev)[:, None] * c + lab0.long()
    flat = torch.where(val, flat, b * c).reshape(-1)
    hist = {"shape": [b, n, c],
            "ms": time_ms(lambda: label_hist_kernel(lab0, val, c)),
            "plain": time_ms(lambda: label_hist_ref(lab0, val, c)),
            "lib": time_ms(lambda: torch.bincount(flat, minlength=b * c + 1))}
    hist["bound"], hist["by"] = bound(lab0.numel() * 4 + val.numel()
                                      + b * c * 4, float(val.sum().item()))
    say(f"label_hist on the engine's round-0 inputs {tuple(hist['shape'])}: "
        f"kernel {hist['ms']:.4f} ms (warm), bound {hist['bound']:.5f} ms "
        f"({hist['by']}), plain {hist['plain']:.4f} ms, bincount "
        f"{hist['lib']:.4f} ms")
    return {"weighted_agg": agg, "label_hist": hist}


def _tf32(cudnn: bool, matmul: bool):
    """Set cuDNN's and cuBLAS's TF32 flags; returns the ones they replace."""
    import torch
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    return old


def _grid_run(dev, ds, **kw) -> dict:
    """One 21-trial grid through ``run``, its launch counts read around it;
    -> the result, the counts, the warm round's wall time and the peak."""
    import torch
    from repro_torch import kernels
    from repro_torch.fl import run
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(_grid_spec(**kw), ds=ds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    meta = res.meta["sim"]
    return {"res": res, "launches": launches, "wall_s": wall,
            "round_s": meta["round_s"], "peak_bytes": meta["peak_bytes"],
            "chunk_trials": meta["chunk_trials"]}


def _say_grid(what: str, g: dict, trials: int, base_round_s: float) -> None:
    warm = g["round_s"][-1]
    say(f"{what}: launches {g['launches']}; rounds "
        f"{[f'{x:.3f}' for x in g['round_s']]} s wall, warm round "
        f"{warm:.3f} s ({warm / trials * 1e3:.1f} ms a trial; phase 13b's "
        f"warm round {base_round_s:.3f} s, "
        f"{base_round_s / trials * 1e3:.1f} ms a trial); training chunk "
        f"{g['chunk_trials']} trials; peak {g['peak_bytes'] / 1e9:.2f} GB")


def phase14ab_grid(dev, base_round_s: float) -> dict:
    import numpy as np
    from repro_torch.data import ImageDataset
    spec = _grid_spec()
    trials = len(spec.scenarios) * len(spec.strategies)
    m_c = 4
    say(f"== 14a. main path: {CLUSTERED} through run(ExperimentSpec("
        f"engine='sim')), {trials} trials, {GRID_ROUNDS} rounds, paper width")
    ds = ImageDataset(device=dev)
    old = _tf32(True, False)
    try:
        clus = _grid_run(dev, ds, aggregation=CLUSTERED)
        want = {"label_hist": GRID_ROUNDS, "weighted_agg": m_c * GRID_ROUNDS,
                "flash_attention": 0, "flash_attention_bwd": 0,
                "ssd_scan": 0}
        if clus["launches"] != want:
            raise AssertionError(f"clustered grid launches {clus['launches']}"
                                 f", expected {want}")
        res = clus["res"]
        cl = res.cluster_trajectories()
        if cl["n_clusters"] != m_c or cl["assign"].shape != (
                7, 3, 1, GRID_ROUNDS, spec.fl.num_clients):
            raise AssertionError(f"clustered grid: detail {cl['assign'].shape}")
        for name in ("accuracy", "loss"):
            if not (np.isfinite(getattr(res, name)).all()
                    and np.isfinite(cl[name]).all()):
                raise AssertionError(f"clustered grid: non-finite {name}")
        occupied = [len(np.unique(cl["assign"][k, 0, 0, 0]))
                    for k in range(7)]
        say(f"clustered: clusters occupied in round 0 by case {occupied}; "
            f"final mixture acc " + " ".join(
                f"{sc}={res.accuracy[k, 1, 0, -1]:.4f}"
                for k, sc in enumerate(res.scenarios)) + " (labelwise)")
        _say_grid(CLUSTERED, clus, trials, base_round_s)

        say("== 14e. the same grid with telemetry=('auto',)")
        tel = _grid_run(dev, ds, aggregation=CLUSTERED, telemetry=("auto",))
        for name in ("accuracy", "loss", "num_selected"):
            if not np.array_equal(getattr(tel["res"], name),
                                  getattr(res, name)):
                raise AssertionError(f"telemetry on changed {name}")
        tc = tel["res"].cluster_trajectories()
        for name in ("accuracy", "loss", "assign"):
            if not np.array_equal(tc[name], cl[name]):
                raise AssertionError(f"telemetry on changed cluster {name}")
        series = tel["res"].telemetry()
        if set(series) != {"selection_entropy", "selected_label_hist",
                           "update_norm", "cluster_occupancy",
                           "centroid_drift"}:
            raise AssertionError(f"telemetry series {sorted(series)}")
        say(f"telemetry on: trajectories and cluster detail bit-identical to "
            f"14a; series {sorted(series)}; warm round "
            f"{tel['round_s'][-1]:.3f} s")

        say(f"== 14b. robust reducers under {ATTACK}")
        robust = {}
        for name in ROBUST:
            g = _grid_run(dev, ds, aggregation=name, adversary=ATTACK)
            want = {"label_hist": GRID_ROUNDS, "weighted_agg": 0,
                    "flash_attention": 0, "flash_attention_bwd": 0,
                    "ssd_scan": 0}
            if g["launches"] != want:
                raise AssertionError(f"{name} grid launches {g['launches']}, "
                                     f"expected {want}")
            r = g["res"]
            if not (np.isfinite(r.accuracy).all()
                    and np.isfinite(r.loss).all()):
                raise AssertionError(f"{name}: non-finite trajectory")
            _say_grid(name, g, trials, base_round_s)
            robust[name] = g
    finally:
        _tf32(*old)
    return {"clustered": clus, "telemetry": tel, "robust": robust,
            "trials": trials}


def phase14c_vs_host(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import FLConfig
    from repro_torch.core import case_label_plan
    from repro_torch.data import ImageDataset
    from repro_torch.fl import GridRun, run_fl_host
    say("== 14c. three grid trials against run_fl_host on the card (TF32 "
        "off): clustered, and krum + poison")
    old = _tf32(False, False)
    cfg = FLConfig()
    cases = ("case1b", "case2b", "iid")
    plans = np.stack([case_label_plan(c, 0, GRID_ROUNDS, cfg.num_clients)
                      for c in cases])
    ds = ImageDataset(device=dev)
    poison = {"frac": ATTACK["frac"], "behaviors": ["poison"],
              "scale": ATTACK["scale"]}
    from repro_torch.core import adversary_mask
    adv = adversary_mask(104729, cfg.num_clients, poison["frac"])
    worst = {"update_rel": 0.0, "loss_rel": 0.0, "acc": 0.0}
    try:
        for agg, adversary in ((CLUSTERED, None), ("krum", poison)):
            grid = GridRun(plans, cfg, strategies=GRID_STRATEGIES, seeds=(0,),
                           rounds=GRID_ROUNDS, ds=ds, aggregation=agg,
                           adversary=adversary,
                           adv=None if adversary is None else adv[None],
                           device=dev)
            infos = [grid.round(t) for t in range(GRID_ROUNDS)]
            res = grid.result(0.0)
            for k in range(3):
                strategy = GRID_STRATEGIES[k]
                trial = k * len(GRID_STRATEGIES) + k
                advt = (None if adversary is None else
                        torch.from_numpy(adv.astype(np.float32)).to(dev))
                init, params, host = _host_trace(
                    plans[k], cfg, strategy, 0, ds, GRID_ROUNDS, agg,
                    None if adversary is None else poison["scale"], advt)
                names = ["hists", "mask", "selected"]
                if adversary is None:
                    names.append("assign")
                for t, info in enumerate(infos):
                    for name in names:
                        g = info[name if name != "assign" else "assign"][trial]
                        if not torch.equal(g, host[name][t]):
                            raise AssertionError(
                                f"{agg} grid vs host: {cases[k]}/{strategy} "
                                f"round {t} {name} differ")
                nsel = [float(x) for x in host["num_selected"]]
                if res.num_selected[k, k, 0].tolist() != nsel:
                    raise AssertionError(f"{agg}: num_selected "
                                         f"{res.num_selected[k, k, 0]} vs "
                                         f"{nsel}")
                hist = run_fl_host(plans[k], cfg, strategy=strategy,
                                   aggregation=agg, rounds=GRID_ROUNDS,
                                   seed=0, ds=ds, adversary=adversary,
                                   adv=None if adversary is None else adv,
                                   device=dev)
                upd = torch.cat([(params[n] - init[n]).reshape(-1)
                                 for n in params])
                gap = torch.cat([(grid.params[n][trial] - params[n])
                                 .reshape(-1) for n in params])
                rel = float(gap.norm() / upd.norm())
                gap_loss = np.abs(res.loss[k, k, 0] - np.asarray(hist.loss))
                loss_rel = float(np.max(np.where(
                    gap_loss == 0, 0.0,
                    gap_loss / np.maximum(np.abs(hist.loss), 1e-30))))
                acc = float(np.max(np.abs(res.accuracy[k, k, 0]
                                          - hist.accuracy)))
                if adversary is None and hist.cluster_assign != \
                        res.cluster_assign[k, k, 0].tolist():
                    raise AssertionError(f"{agg}: run_fl_host's assignments "
                                         "differ from the grid's")
                say(f"  {agg} {cases[k]}/{strategy}: histograms, masks, "
                    f"orders{', assignments' if adversary is None else ''}, "
                    f"num_selected {nsel} bit-equal; |param gap| / |update| "
                    f"{rel:.3e}, loss rel {loss_rel:.3e}, accuracy {acc:.4f}")
                worst = {"update_rel": max(worst["update_rel"], rel),
                         "loss_rel": max(worst["loss_rel"], loss_rel),
                         "acc": max(worst["acc"], acc)}
    finally:
        _tf32(*old)
    if not (worst["update_rel"] <= ADAM_REL
            and worst["loss_rel"] <= GRID_LOSS_REL
            and worst["acc"] <= GRID_ACC_ATOL):
        raise AssertionError(f"phase 14 grid vs host beyond the limits: "
                             f"{worst}")
    return worst


def phase14d_card_vs_cpu(dev, trials: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import get_aggregator, kmeans_cluster, krum_scores
    from repro_torch.data import ImageDataset
    from repro_torch.fl import GridRun
    from repro_torch.kernels.dispatch import masked_weighted_mean
    from repro_torch.models import cnn_init
    say("== 14d. k-means and the robust reducers on the card against the CPU")
    spec = _grid_spec()
    ds = ImageDataset(device=dev)
    plans = np.stack([s.lower(spec.fl, spec.seeds, GRID_ROUNDS).plan
                      for s in spec.scenarios])
    grid = GridRun(plans, spec.fl, strategies=spec.strategies,
                   seeds=spec.seeds, rounds=GRID_ROUNDS, ds=ds, device=dev)
    hists = grid.wl.hists(ds, grid.plans[grid.plan_idx, 0])["hists"]
    for m in (2, 4, 8):
        a_gpu, c_gpu = kmeans_cluster(hists, m)
        a_cpu, c_cpu = kmeans_cluster(hists.cpu(), m)
        if not (torch.equal(a_gpu.cpu(), a_cpu)
                and torch.equal(c_gpu.cpu(), c_cpu)):
            raise AssertionError(f"k-means M={m}: card differs from the CPU")
    say(f"k-means of the round-0 histograms {tuple(hists.shape)}, M = 2, 4, "
        f"8: assignments and centroids bit-equal to the CPU")
    shapes = {k: tuple(v.shape) for k, v in cnn_init(device=dev).items()}
    g = np.random.default_rng(14)
    tree = {k: (0.05 * g.standard_normal((K_CLIENTS,) + s)
                + 0.01 * g.standard_normal((K_CLIENTS,) + (1,) * len(s)))
            .astype(np.float32) for k, s in shapes.items()}
    live = (g.random(K_CLIENTS) > 0.2).astype(np.float32)
    sizes = g.uniform(30, 290, K_CLIENTS).astype(np.float32)
    cpu = ({k: torch.from_numpy(v) for k, v in tree.items()},
           torch.from_numpy(live), torch.from_numpy(sizes))
    card = ({k: v.to(dev) for k, v in cpu[0].items()}, cpu[1].to(dev),
            cpu[2].to(dev))
    checks = {}
    for name in ROBUST:
        fn = get_aggregator(name).reduce
        got, want = fn(*card), fn(*cpu)
        ulp = max(int(_ulp_gap(got[k], want[k]).max()) for k in want)
        checks[name] = ulp
        if name == "median" and ulp != 0:
            raise AssertionError(f"median: card {ulp} ulp from the CPU")
        if name == "trimmed_mean" and ulp > TRIM_ULP:
            raise AssertionError(f"trimmed_mean: card {ulp} ulp from the CPU")
        if name == "krum" and ulp != 0:
            raise AssertionError("krum: the card picked another client")
    scores = torch.sort(krum_scores({k: v[None] for k, v in card[0].items()},
                                    card[1][None])[0]).values.cpu()
    margin = float((scores[1] - scores[0]) / scores[0])
    say(f"reducers at the CNN's leaves, K={K_CLIENTS}, "
        f"{int(live.sum())} live: median {checks['median']} ulp, "
        f"trimmed_mean {checks['trimmed_mean']} ulp (limit {TRIM_ULP}), krum "
        f"the same client (score margin to the next {margin:.3e} relative)")
    # Device time a round at the grid's shape: (trials, 30, ...) updates.
    big = {k: torch.from_numpy(np.broadcast_to(
        v, (trials,) + v.shape).copy()).to(dev) for k, v in tree.items()}
    del tree
    lv = torch.from_numpy(np.stack([np.roll(live, t) for t in range(trials)])
                          ).to(dev)
    sz = torch.from_numpy(np.broadcast_to(sizes, (trials, K_CLIENTS)).copy()
                          ).to(dev)
    times = {name: time_ms(lambda f=get_aggregator(name).reduce: f(big, lv,
                                                                    sz),
                           reps=2, trials=5) for name in ROBUST}
    m_c = 4
    assign = torch.from_numpy(g.integers(0, m_c, (trials, K_CLIENTS))
                              ).to(dev)
    clus_ms = time_ms(lambda: [masked_weighted_mean(
        big, lv * (assign == c).to(lv.dtype), sz) for c in range(m_c)],
        reps=5, trials=10)
    one_ms = time_ms(lambda: masked_weighted_mean(big, lv, sz), reps=5,
                     trials=10)
    n = sum(math.prod(s) for s in shapes.values())
    # The function's bound: the (T, K, n) stack read once, the M·T models
    # written once, each element weighted into one cluster.  The M-launch
    # design reads the stack M times; its traffic is printed beside.
    c_bound, c_by = bound(4 * (trials * K_CLIENTS * n + m_c * trials * n),
                          2 * trials * K_CLIENTS * n)
    design_ms = 4 * m_c * (trials * K_CLIENTS * n + trials * n) \
        / HBM_BYTES_PER_S * 1e3
    say(f"device time a round at ({trials}, {K_CLIENTS}, the CNN's "
        f"{n} params): " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                     times.items())
        + f"; the clustered reduction, {m_c} weighted_agg launches "
        f"{clus_ms:.4f} ms (the function's bound {c_bound:.4f} ms, {c_by}; "
        f"the {m_c}-launch design's traffic {design_ms:.4f} ms), one launch "
        f"{one_ms:.4f} ms")
    return {"reducer_ms": times, "reducer_ulp": checks, "krum_margin": margin,
            "clustered_ms": clus_ms, "clustered_bound_ms": c_bound,
            "clustered_design_traffic_ms": design_ms,
            "clustered_bound_by": c_by, "one_launch_ms": one_ms}


def _pop_spec(engine: str, **kw):
    from repro_torch.configs import FLConfig
    from repro_torch.fl import ExperimentSpec, ScenarioSpec
    base = dict(scenarios=(ScenarioSpec.from_case("case1b"),),
                strategies=POP_STRATEGIES, seeds=(0,), engine=engine,
                fl=FLConfig(), rounds=POP_ROUNDS)
    base.update(kw)
    return ExperimentSpec(**base)


def _pop_run(dev, ds, spec, want: dict) -> dict:
    """``run(spec)`` with the launch counts set to 0 just before and read
    just after, held to ``want``; finite trajectories."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.fl import run
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(spec, ds=ds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    want = {"flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": 0,
            **want}
    if launches != want:
        raise AssertionError(f"{spec.engine}: launches {launches}, expected "
                             f"{want}")
    if not (np.isfinite(res.accuracy).all() and np.isfinite(res.loss).all()):
        raise AssertionError(f"{spec.engine}: non-finite trajectory")
    return {"res": res, "launches": launches, "wall_s": wall}


def _pop_pin(what: str, got: dict, want: dict) -> float:
    """max |diff| of two runs' loss and accuracy, held to POP_PIN, with
    ``num_selected`` equal (dicts or results with those three arrays)."""
    import numpy as np
    def arr(r, k):
        return np.asarray(r[k] if isinstance(r, dict) else getattr(r, k),
                          np.float64).ravel()
    if not np.array_equal(arr(got, "num_selected"),
                          arr(want, "num_selected")):
        raise AssertionError(f"{what}: num_selected differs")
    gap = max(float(np.abs(arr(got, k) - arr(want, k)).max())
              for k in ("loss", "accuracy"))
    if not gap <= POP_PIN:
        raise AssertionError(f"{what}: trajectories {gap:.3e} apart, over "
                             f"{POP_PIN}")
    return gap


def phase15ab_engines(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.data import ImageDataset
    from repro_torch.fl import (GridRun, ScenarioSpec, availability,
                                make_async_trial_fn, make_hier_trial_fn)
    ds = ImageDataset(device=dev)
    trials = len(POP_STRATEGIES)
    rounds = trials * POP_ROUNDS
    spec_h = _pop_spec("hier")
    spec_a = _pop_spec("async", scenarios=(ScenarioSpec.from_case(
        "case1b", transforms=(availability(0.3),)),),
        engine_options=POP_ASYNC)
    old = _tf32(True, False)
    try:
        say(f"== 15a. main path: run(ExperimentSpec(engine='hier')), case1b x "
            f"{POP_STRATEGIES} x 1 seed, {POP_ROUNDS} rounds, paper width")
        # One label_hist launch a round (all 10 blocks in one chunk), no
        # weighted_agg: the two-tier sum is a plain product.
        hier = _pop_run(dev, ds, spec_h, {"label_hist": rounds,
                                          "weighted_agg": 0})
        pop = hier["res"].meta["population"]
        if (pop["num_blocks"], pop["block_size"]) != (10, 10):
            raise AssertionError(f"hier: blocks {pop}")
        lw = make_hier_trial_fn(spec_h.fl, ds, strategy="labelwise",
                                rounds=POP_ROUNDS)
        plan = spec_h.scenarios[0].lower(spec_h.fl, (0,), POP_ROUNDS).plan
        h_round = lw(plan, 0)["round_s"]
        say(f"hier: launches {hier['launches']}; meta {pop}; final acc "
            + " ".join(f"{s}={hier['res'].accuracy[0, i, 0, -1]:.4f}"
                       for i, s in enumerate(POP_STRATEGIES))
            + f"; run {hier['wall_s']:.3f} s for {rounds} trial-rounds; "
            f"labelwise alone: rounds {[f'{x:.3f}' for x in h_round]} s")

        say(f"== 15b. main path: run(ExperimentSpec(engine='async')), "
            f"availability(0.3), {POP_ASYNC}")
        # Each window: one label_hist launch (the round's histograms) and
        # one weighted_agg launch (the K arrivals' means, trial axis).
        asy = _pop_run(dev, ds, spec_a, {"label_hist": rounds,
                                         "weighted_agg": rounds})
        pop_a = asy["res"].meta["population"]
        if not pop_a["delay_max"] > 0:
            raise AssertionError(f"async: no staleness under availability: "
                                 f"{pop_a}")
        low = spec_a.scenarios[0].lower(spec_a.fl, (0,), POP_ROUNDS)
        from repro_torch.fl.population import derive_arrival_schedule
        sched = derive_arrival_schedule(
            low.plan, low.avail, rounds=POP_ROUNDS, num_blocks=10,
            block_size=10, buffer_k=POP_ASYNC["buffer_k"],
            tau_max=POP_ASYNC["tau_max"])
        a_round = make_async_trial_fn(
            spec_a.fl, ds, strategy="labelwise", rounds=POP_ROUNDS,
            num_blocks=10, schedule=sched, **POP_ASYNC)(low.plan, 0)["round_s"]
        say(f"async: launches {asy['launches']}; meta {pop_a}; final acc "
            + " ".join(f"{s}={asy['res'].accuracy[0, i, 0, -1]:.4f}"
                       for i, s in enumerate(POP_STRATEGIES))
            + f"; selected {asy['res'].num_selected[0, :, 0].tolist()}; run "
            f"{asy['wall_s']:.3f} s for {rounds} trial-windows; labelwise "
            f"alone: windows {[f'{x:.3f}' for x in a_round]} s")
    finally:
        _tf32(*old)

    say("== 15c'. TF32 off: hier against sim (labelwise), degenerate async "
        "against sim (full)")
    old = _tf32(False, False)
    try:
        hier_lw = lw(plan, 0)
        grid = GridRun(plan[None], spec_h.fl, strategies=("labelwise",),
                       seeds=(0,), rounds=POP_ROUNDS, ds=ds, device=dev)
        for t in range(POP_ROUNDS):
            sel = grid.round(t)
            if not (np.array_equal(hier_lw["selected"][t],
                                   sel["selected"][0].cpu().numpy())
                    and np.array_equal(hier_lw["live"][t],
                                       sel["live"][0].cpu().numpy())):
                raise AssertionError(f"hier round {t}: selection differs "
                                     f"from sim's order[:budget]")
        gap_h = _pop_pin("hier vs sim", hier_lw, grid.result(0.0))
        full = dict(strategies=("full",))
        deg = _pop_run(dev, ds, _pop_spec(
            "async", engine_options={"buffer_k": 10, "tau_max": 0}, **full),
            {"label_hist": POP_ROUNDS, "weighted_agg": POP_ROUNDS})
        sim = _pop_run(dev, ds, _pop_spec("sim", **full),
                       {"label_hist": POP_ROUNDS,
                        "weighted_agg": POP_ROUNDS})
        gap_a = _pop_pin("degenerate async vs sim", deg["res"], sim["res"])
        say(f"hier selections bit-equal to sim's order[:budget] in each "
            f"round; trajectories {gap_h:.3e} apart; degenerate async (full, "
            f"selected {deg['res'].num_selected.ravel().tolist()}) "
            f"{gap_a:.3e} from sim (limit {POP_PIN})")
    finally:
        _tf32(*old)
    return {"hier": hier, "async": asy, "hier_round_s": h_round,
            "async_round_s": a_round, "hier_sim_gap": gap_h,
            "async_sim_gap": gap_a}


def phase15c_population(dev) -> dict:
    import torch
    from repro_torch import kernels
    from repro_torch.data import ImageDataset
    from repro_torch.fl import make_population_round, synthetic_population_plan
    from repro_torch.fl.population import _CHUNK_ROWS
    from repro_torch.models import cnn_init
    from repro_torch.rng import PRNGKey
    say(f"== 15c. main path: make_population_round, blocks of {POP_BLOCK}, "
        f"{POP_BUDGET} selected, {POP_SPC} samples a client, SGD, one round "
        f"at N = {', '.join(str(n) for n in POP_NS)}")
    ds = ImageDataset(device=dev)
    params = cnn_init(PRNGKey(0), device=dev)
    plan_fn = synthetic_population_plan(samples_per_client=POP_SPC)
    key_t = PRNGKey(7)

    def round_at(n, device=dev, data=ds, chunk=None):
        return make_population_round(
            plan_fn=plan_fn, num_clients=n, block_size=POP_BLOCK,
            strategy="labelwise", budget=POP_BUDGET, ds=data,
            batch_size=POP_SPC, chunk_blocks=chunk, device=device)

    round_at(POP_NS[0])(params, key_t)          # warm-up: first calls
    torch.cuda.synchronize()
    rows = {}
    for n in POP_NS:
        rnd = round_at(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        new, info = rnd(params, key_t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        chunks = -(-rnd.num_blocks // max(1, _CHUNK_ROWS // POP_BLOCK))
        # One label_hist launch a chunk of blocks, one for the selected
        # rows' payload; the two-tier sum is a plain product.
        want = {"label_hist": chunks + 1, "weighted_agg": 0,
                "flash_attention": 0, "flash_attention_bwd": 0,
                "ssd_scan": 0}
        if launches != want:
            raise AssertionError(f"population N={n}: launches {launches}, "
                                 f"expected {want}")
        if not (float(info["num_selected"]) > 0 and all(
                bool(torch.isfinite(v).all()) for v in new.values())):
            raise AssertionError(f"population N={n}: nothing selected or "
                                 f"non-finite params")
        if int(info["n_valid"]) != n:
            raise AssertionError(f"population N={n}: {int(info['n_valid'])} "
                                 f"clients counted")
        rows[n] = {"wall_s": wall, "peak_bytes": peak,
                   "launches": launches["label_hist"], "chunks": chunks,
                   "num_selected": float(info["num_selected"]),
                   "union_coverage": int(info["union_coverage"])}
        say(f"N={n:8d}: {rnd.num_blocks} blocks in {chunks} chunks, "
            f"{launches['label_hist']} label_hist launches; round "
            f"{wall * 1e3:.1f} ms wall; peak {peak / 1e6:.1f} MB over the "
            f"{base / 1e6:.1f} MB held; selected "
            f"{rows[n]['num_selected']:.0f}, classes covered "
            f"{rows[n]['union_coverage']}")
    full = [n for n in POP_NS if n >= _CHUNK_ROWS]
    ratio = rows[full[-1]]["peak_bytes"] / rows[full[0]]["peak_bytes"]
    if ratio > 1.5:
        raise AssertionError(f"population: peak memory grows with N once "
                             f"the chunks are full ({ratio:.2f}x from "
                             f"N={full[0]} to N={full[-1]})")
    say(f"peak memory, full chunks: N={full[-1]} is {ratio:.3f}x N="
        f"{full[0]}")
    # Card against CPU, and two chunkings, at POP_CHECK_N.
    cpu_ds = ImageDataset(device="cpu")
    runs = {"card": round_at(POP_CHECK_N)(params, key_t),
            f"card, chunks of {POP_CHUNK_ALT} blocks": round_at(
                POP_CHECK_N, chunk=POP_CHUNK_ALT)(params, key_t),
            "cpu": round_at(POP_CHECK_N, "cpu", cpu_ds)(
                {k: v.cpu() for k, v in params.items()}, key_t.cpu())}
    ref = runs["card"][1]
    for what, (_, info) in runs.items():
        for k in ("selected", "live", "scores", "hist_sum", "n_valid",
                  "union_coverage"):
            if not torch.equal(info[k].cpu(), ref[k].cpu()):
                raise AssertionError(f"population N={POP_CHECK_N}: {k} of "
                                     f"{what} differs from the card's")
    gap = max(float((runs["cpu"][0][k] - runs["card"][0][k].cpu()).abs()
                    .max()) for k in params)
    say(f"N={POP_CHECK_N}: ids, live flags, scores and statistics bit-equal "
        f"card vs CPU and across chunkings; params max |card - cpu| "
        f"{gap:.3e}")
    return {"rows": rows, "peak_ratio": ratio}


def phase15d_kernels(dev) -> dict:
    import math
    import numpy as np
    import torch
    from repro_torch.fl import synthetic_population_plan
    from repro_torch.kernels.label_hist import label_hist_kernel, label_hist_ref
    from repro_torch.kernels.weighted_agg import (weighted_agg_leaves,
                                                  weighted_agg_ref)
    from repro_torch.models import cnn_init
    from repro_torch.rng import PRNGKey
    say("== 15d. label_hist and weighted_agg at the population engines' "
        "shapes")
    plan_fn = synthetic_population_plan(samples_per_client=POP_SPC)
    c = 10
    hist = {}
    for rows in (POP_BUDGET, POP_BLOCK, 1 << 16):
        lab = plan_fn(PRNGKey(3, dev), torch.arange(rows, device=dev))
        val = torch.from_numpy(np.random.default_rng(rows).random(
            lab.shape) > 0.1).to(dev)
        lab0 = torch.where(val, lab, 0)
        if not torch.equal(label_hist_kernel(lab0, val, c),
                           label_hist_ref(lab0, val, c)):
            raise AssertionError(f"label_hist differs at ({rows}, {POP_SPC}, "
                                 f"{c})")
        flat = torch.arange(rows, device=dev)[:, None] * c + lab0.long()
        flat = torch.where(val, flat, rows * c).reshape(-1)
        h = {"ms": time_ms(lambda: label_hist_kernel(lab0, val, c)),
             "plain": time_ms(lambda: label_hist_ref(lab0, val, c)),
             "lib": time_ms(lambda: torch.bincount(flat,
                                                   minlength=rows * c + 1))}
        h["bound"], h["by"] = bound(lab0.numel() * 4 + val.numel()
                                    + rows * c * 4, float(val.sum().item()))
        hist[rows] = h
        say(f"label_hist ({rows}, {POP_SPC}, {c}): bit-equal; kernel "
            f"{h['ms']:.4f} ms, bound {h['bound']:.6f} ms ({h['by']}), plain "
            f"{h['plain']:.4f} ms, bincount {h['lib']:.4f} ms")
    # async's per-window reduction: K arrivals (the trial axis) of
    # block_budget clients each, over the CNN's leaves.
    k_arr, k_cl = POP_ASYNC["buffer_k"], 10
    sizes = [math.prod(v.shape) for v in cnn_init(device=dev).values()]
    g = np.random.default_rng(15)
    xs = [torch.from_numpy(0.05 * g.standard_normal(
        (k_arr, k_cl, n)).astype(np.float32)).to(dev) for n in sizes]
    w = torch.from_numpy((g.uniform(30, 290, (k_arr, k_cl))
                          * (g.random((k_arr, k_cl)) > 0.2))
                         .astype(np.float32)).to(dev)
    denom = torch.clamp(w.sum(-1), min=1e-12)
    got = weighted_agg_leaves(xs, w, denom)
    err = 0.0
    for x, y in zip(xs, got):
        want = weighted_agg_ref(x, w, denom)
        tol = (2 * k_cl * 2.0 ** -24 * torch.einsum("tk,tkn->tn", w, x.abs())
               / denom[:, None] + 2.0 ** -23 * want.abs())
        e = (y - want).abs()
        if bool((e > tol).any()):
            raise AssertionError(f"weighted_agg (K={k_arr} arrivals): "
                                 f"{e.max().item()} over the float32 bound")
        err = max(err, e.max().item())
    agg = {"ms": time_ms(lambda: weighted_agg_leaves(xs, w, denom)),
           "plain": time_ms(lambda: [weighted_agg_ref(x, w, denom)
                                     for x in xs]),
           "lib": time_ms(lambda: [torch.bmm(w[:, None, :], x) for x in xs]),
           "err": err, "shape": [k_arr, k_cl, sum(sizes)]}
    nbytes = sum(k_arr * (k_cl * n + k_cl + n) * 4 for n in sizes)
    agg["bound"], agg["by"] = bound(nbytes, 2 * k_arr * k_cl * sum(sizes))
    say(f"weighted_agg ({k_arr} arrivals, {k_cl} clients each, "
        f"{sum(sizes)} columns): max abs err {err:.3e}; kernel "
        f"{agg['ms']:.4f} ms, bound {agg['bound']:.4f} ms ({agg['by']}, "
        f"{nbytes / 1e6:.1f} MB), plain {agg['plain']:.4f} ms, bmm a leaf "
        f"{agg['lib']:.4f} ms")
    return {"label_hist": hist, "weighted_agg": agg}


# Phase 16: LM training.  (a) the flash backward kernels against the plain
# backward and a float64 plain backward, each gradient's max |diff| over its
# max |value|.  The limits are twice the plain backward's own error in the
# input dtype against float64, read by this phase on its first eight shapes
# (H100 80GB HBM3 at 700 W, PERF.md): at most 1.13e-6 in float32 and
# 3.44e-3 in bfloat16, the CUDA-core pair's own gaps to the plain version
# then 4.4e-7 and 1.8e-3.
BWD_TOL = {"float32": 2.5e-6, "bfloat16": 7e-3}
BWD_SHAPES = [          # (B, S, H, KV, D, dtype, causal, window)
    (4, 1024, 40, 8, 128, "bfloat16", True, 0),
    (4, 1024, 40, 8, 128, "bfloat16", True, 256),
    (2, 77, 10, 10, 16, "float32", True, 0),
    (2, 77, 10, 5, 32, "float32", True, 5),
    (2, 130, 10, 2, 64, "float32", True, 0),
    (1, 130, 4, 2, 128, "float32", False, 0),
    (2, 77, 10, 2, 16, "float32", False, 7),
    (1, 333, 10, 2, 128, "bfloat16", True, 40),
    # The tensor-core pair's edges: head_dim 64, GQA groups 8 and 1, S of
    # no multiple of 64 or 128, no causal mask (with and without a window),
    # a window shorter than a tile.
    (2, 77, 8, 1, 64, "bfloat16", True, 0),
    (1, 190, 6, 6, 64, "bfloat16", False, 0),
    (2, 300, 16, 2, 128, "bfloat16", True, 20),
    (1, 257, 4, 2, 128, "bfloat16", False, 33),
]
# (b)–(d): gradients on the card against the CPU (TF32 off) within GRAD_TOL
# of each leaf's largest magnitude, the limit that holds the port's
# gradients to the reference's (tests/test_torch_train.py).
GRAD_TOL = 1e-4
VMAP_CLIENTS = 6
# (e) the lm FL workload: examples/fl_lm_pretrain.py's spec (fl-lm-12m, 16
# clients, 6 a round, 8 domains, 8 sequences of 64 tokens, 2 local epochs,
# Adam 1e-3) for LM_ROUNDS rounds, card against CPU (TF32 off): selections
# bit-equal; the eval loss within LM_LOSS_REL and the accuracy within
# LM_ACC_TOKENS of the eval stream's next-token predictions.  Both are
# wider than the CPU-against-reference pins (1e-4, 2 tokens) because Adam's
# first steps move each coordinate by about ±lr whatever its gradient's
# size, so a coordinate whose gradient is rounding noise can step the other
# way on the other device (phase 5's reason for ADAM_REL).
LM_ROUNDS = 3
LM_LOSS_REL = 1e-3
LM_ACC_TOKENS = 4
FL_LM_CFG = dict(name="fl-lm-12m", arch_type="dense", num_layers=4,
                 d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                 vocab_size=512, dtype="float32", fsdp=False, remat=False,
                 scan_layers=False)
# (f) full width: run_train's steps at TRAIN_BATCH x TRAIN_SEQ; qwen3-14b
# cut to TRAIN_QWEN_LAYERS layers (40 layers in bf16 with bf16 moments need
# about 112 GB), mamba2-1.3b at full depth.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_QWEN_LAYERS = 5, 4, 1024, 4


def _rel(got, want) -> float:
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def phase16a_flash_backward(dev) -> dict:
    """The flash backward kernel pair against the plain backward at
    BWD_SHAPES, and its times at qwen3-14b's prefill shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     FlashAttentionBackward,
                                                     gqa_attention_bwd_ref)
    say("== 16a. flash_attention backward against the plain backward")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(16)
    worst_abs, readings = 0.0, {}
    for b, s, h, kv, d, dt, causal, window in BWD_SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype)
                for _ in range(2))
        do = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
        o, lse = FlashAttention.apply(q, k, v, causal, window, True)
        got = FlashAttentionBackward.apply(q, k, v, o, lse, do, causal,
                                           window)
        plain = gqa_attention_bwd_ref(q, k, v, o, do, causal, window)
        exact = gqa_attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                                      causal, window)
        torch.cuda.synchronize()
        k_vs_p = max(_rel(a, c) for a, c in zip(got, plain))
        p_vs_64 = max(_rel(c, e) for c, e in zip(plain, exact))
        k_vs_64 = max(_rel(a, e) for a, e in zip(got, exact))
        worst_abs = max(worst_abs, max((a.float() - c.float()).abs().max()
                                       .item() for a, c in zip(got, plain)))
        what = (b, s, h, kv, d, dt, causal, window)
        readings[str(what)] = (k_vs_p, p_vs_64)
        say(f"flash backward {what}: kernel vs plain {k_vs_p:.2e}, plain "
            f"vs float64 {p_vs_64:.2e}, kernel vs float64 {k_vs_64:.2e} "
            f"(of max |grad|; limit {BWD_TOL[dt]:.1e})")
        if not max(k_vs_p, k_vs_64) <= BWD_TOL[dt] or not all(
                bool(torch.isfinite(x).all()) for x in got):
            raise AssertionError(f"flash backward {what}: {k_vs_p} (plain), "
                                 f"{k_vs_64} (float64) > {BWD_TOL[dt]}")
        del q, k, v, do, o, lse, got, plain, exact
    torch.cuda.empty_cache()
    b, s, h, kvh, d = SERVE_BATCH, SERVE_PROMPT, 40, 8, 128
    q = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((b, s, kvh, d), generator=g, device=dev).bfloat16()
            for _ in range(2))
    do = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
    o, lse = FlashAttention.apply(q, k, v, True, 0, True)
    t = {"ms": time_ms(lambda: FlashAttentionBackward.apply(
        q, k, v, o, lse, do, True, 0), reps=5, trials=7),
         "plain": time_ms(lambda: gqa_attention_bwd_ref(q, k, v, o, do),
                          reps=2, trials=5)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    both = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                   reps=5, trials=7)
    fwd = time_ms(sdpa, reps=5, trials=7)
    t["lib"] = both - fwd
    nbytes = 2 * (4 * q.numel() + 4 * k.numel())   # q o do dq, k v dk dv
    ops = 10 * b * h * d * s * (s + 1) // 2   # 5 products of the live pairs
    t["bound"], t["by"] = bound(nbytes, ops, BF16_OPS_PER_S)
    t["err"] = worst_abs
    say(f"flash_attention backward (B={b}, S={s}, H={h}, KV={kvh}, D={d}, "
        f"bf16, causal): tensor-core kernels {t['ms']:.4f} ms, bound "
        f"{t['bound']:.4f} ms ({t['by']}: {ops / 1e9:.1f} GFLOP, 2.5x the "
        f"forward's live-pair products, at 989 TFLOP/s bf16; "
        f"{t['bound'] / t['ms']:.1%} of it), plain {t['plain']:.4f} ms, "
        f"scaled_dot_product_attention backward {t['lib']:.4f} ms "
        f"(forward+backward {both:.4f} less forward {fwd:.4f}; the kernels "
        f"take {t['ms'] / t['lib']:.2f}x it)")
    mma = flash_bwd_mma_flops(b, s, h, d)
    say(f"flash_attention backward kernels' own tensor-core work: "
        f"{mma / 1e9:.1f} GFLOP (S and dP once, the products with P and dS "
        f"twice for their hi/lo split, whole diagonal tiles), "
        f"{mma / (t['ms'] * 1e-3) / 1e12:.0f} TFLOP/s achieved")
    # The float32 pair (CUDA cores, unchanged) at the same shape.
    q, k, v, do = (x.float() for x in (q, k, v, do))
    o, lse = FlashAttention.apply(q, k, v, True, 0, True)
    t["f32_ms"] = time_ms(lambda: FlashAttentionBackward.apply(
        q, k, v, o, lse, do, True, 0), reps=2, trials=5)
    say(f"flash_attention backward, the float32 pair (CUDA cores) at the "
        f"same shape: {t['f32_ms']:.4f} ms")
    return t


def _lm_grads(cfg, device, key, toks, targets):
    """d(token_ce(forward)) of the flat params made from ``key`` on the
    CPU, computed on ``device`` -> CPU tensors."""
    import torch
    from repro_torch.models import forward, init_model, token_ce
    from repro_torch.models.transformer import (flatten_params,
                                                unflatten_params)
    flat = flatten_params(init_model(key, cfg, device="cpu"))

    def loss(p):
        logits, _ = forward(unflatten_params(p), cfg,
                            {"tokens": toks.to(device)})
        return token_ce(logits, targets.to(device))[0]

    grads = torch.func.grad(loss)({k: v.to(device) for k, v in flat.items()})
    return {k: v.cpu() for k, v in grads.items()}


def _leaf_gap(got: dict, want: dict) -> float:
    return max((got[k] - want[k]).abs().max().item()
               / max(want[k].abs().max().item(), 1e-30) for k in want)


def _targets(toks):
    targets = toks.roll(-1, 1)
    targets[:, -1] = -1
    return targets


def phase16bd_gradients(dev) -> dict:
    """(b) the SSD Function's gradients at mamba2-1.3b's widths; (d) the
    repaired fault: the model's gradients on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch import kernels, rng
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_apply, ssd_chunked_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    say("== 16b. the SSD Function's gradients, card against CPU (TF32 off)")
    old = _tf32(False, False)
    b, s, h, p, g_, n, chunk = 2, 1024, 64, 64, 1, 128, 128
    args = [a.cpu() for a in _ssd_inputs(dev, b, s, h, p, g_, n, seed=16)]
    w = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (b, s, h, p)).astype(np.float32))
    grads = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        xs = [a.to(d).requires_grad_() for a in args]
        y, fin = ssd_apply(*xs, chunk=chunk)
        ((y * w.to(d)).sum() + fin.sum()).backward()
        grads[side] = {name: x.grad.cpu() for name, x in
                       zip(("x", "dt", "A", "B", "C"), xs)}
    gap = _leaf_gap(grads["card"], grads["cpu"])
    say(f"ssd_apply gradients (b={b}, S={s}, H={h}, P={p}, G={g_}, N={n}, "
        f"chunk {chunk}): card vs CPU {gap:.2e} of max |grad| (limit "
        f"{GRAD_TOL:.0e})")
    if not gap <= GRAD_TOL:
        raise AssertionError(f"SSD gradients card vs CPU: {gap}")
    # The backward's time at the serving phase's shape: a vjp of the chunked
    # form (forward recompute and backward), plain PyTorch.
    big = list(_ssd_inputs(dev, SERVE_BATCH, SERVE_PROMPT, h, p, g_, n,
                           seed=17))
    big[2] = big[2].expand(SERVE_BATCH, h)
    gy = torch.randn((SERVE_BATCH, SERVE_PROMPT, h, p), device=dev)
    gf = torch.randn((SERVE_BATCH, h, p, n), device=dev)

    def ssd_bwd():
        _, vjp = torch.func.vjp(lambda *a: ssd_chunked_ref(*a, chunk), *big)
        return vjp((gy, gf))

    ssd_bwd_ms = time_ms(ssd_bwd, reps=2, trials=5)
    say(f"ssd_scan backward (b={SERVE_BATCH}, S={SERVE_PROMPT}, H={h}, "
        f"P={p}, N={n}, chunk {chunk}): the plain chunked form's vjp "
        f"{ssd_bwd_ms:.4f} ms")

    say("== 16d. the repaired fault: model gradients, card against CPU")
    fault = {}
    for arch, leaves in (("qwen3-14b", ("attn.wq", "attn.wk", "attn.wv")),
                         ("mamba2-1.3b", ("mamba.in_proj",))):
        cfg = get_config(arch).reduced(dtype="float32")
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 200)))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        ssd_ops.vjp_calls = 0
        got = _lm_grads(cfg, dev, rng.PRNGKey(3), toks, _targets(toks))
        launches = {**kernels.launch_counts(), "ssd_vjp": ssd_ops.vjp_calls}
        want = _lm_grads(cfg, torch.device("cpu"), rng.PRNGKey(3), toks,
                         _targets(toks))
        gap = _leaf_gap(got, want)
        named = {k: _leaf_gap({k: got[k]}, {k: want[k]}) for k in got
                 if k.endswith(leaves)}
        named_gaps = ", ".join(f"{k} {v:.1e}" for k, v in named.items())
        say(f"{arch} reduced float32: every leaf within {gap:.2e} of its max "
            f"|grad| (limit {GRAD_TOL:.0e}); {named_gaps}; launches "
            f"{launches}")
        if not gap <= GRAD_TOL or not all(
                want[k].abs().max() > 0 for k in named):
            raise AssertionError(f"{arch}: card gradients differ from the "
                                 f"CPU's by {gap} of their scale")
        fault[arch] = gap
    _tf32(*old)
    return {"ssd_grad_gap": gap, "ssd_bwd_ms": ssd_bwd_ms, "fault": fault}


def phase16c_vmap_grad(dev) -> dict:
    """vmap(grad) of a reduced LM over VMAP_CLIENTS clients: equal to the
    separate calls, and one flash launch each way a layer for all."""
    import numpy as np
    import torch
    from repro_torch import kernels, rng
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model, token_ce
    from repro_torch.models.transformer import (flatten_params,
                                                unflatten_params)
    say(f"== 16c. vmap(grad) of a reduced LM over {VMAP_CLIENTS} clients")
    old = _tf32(False, False)
    cfg = get_config("qwen3-14b").reduced(dtype="float32")
    keys = rng.fold_in(rng.PRNGKey(torch.arange(VMAP_CLIENTS)), 1).to(dev)
    params = flatten_params(init_model(keys, cfg, device=dev))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (VMAP_CLIENTS, 2, 128))).to(dev)
    targets = torch.stack([_targets(t) for t in toks])

    def loss(p, tk, tg):
        logits, _ = forward(unflatten_params(p), cfg, {"tokens": tk})
        return token_ce(logits, tg)[0]

    step = torch.func.vmap(torch.func.grad(loss))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    batched = step(params, toks, targets)
    torch.cuda.synchronize()
    vm = kernels.launch_counts()
    kernels.reset_launch_counts()
    gap = 0.0
    for i in range(VMAP_CLIENTS):
        one = torch.func.grad(loss)({k: v[i] for k, v in params.items()},
                                    toks[i], targets[i])
        gap = max(gap, _leaf_gap({k: batched[k][i] for k in one}, one))
    torch.cuda.synchronize()
    sep = kernels.launch_counts()
    _tf32(*old)
    say(f"vmap(grad) over {VMAP_CLIENTS} clients vs {VMAP_CLIENTS} separate "
        f"grads: {gap:.2e} of max |grad| (limit {GRAD_TOL:.0e}); launches "
        f"vmapped {vm}, separate {sep}")
    layers = cfg.num_layers
    if not gap <= GRAD_TOL or (vm["flash_attention"],
                               vm["flash_attention_bwd"]) != (layers, layers) \
            or sep["flash_attention_bwd"] != VMAP_CLIENTS * layers:
        raise AssertionError(f"vmap(grad): gap {gap}, launches {vm}, "
                             f"separate {sep}")
    return {"gap": gap, "launches": vm}


def _lm_fl_spec(np, engine, rounds, **over):
    from repro_torch.configs import FLConfig
    from repro_torch.fl import ExperimentSpec, ScenarioSpec
    fl = FLConfig(**{**dict(num_clients=16, clients_per_round=6,
                            global_epochs=rounds, local_epochs=2,
                            batch_size=8, lr=1e-3), **over.pop("fl", {})})
    n = over.pop("seqs", 8)
    scenario = ScenarioSpec.from_bias_mix(
        0.7, name="domain-skew", num_classes=over.pop("domains", 8),
        n_min=n, n_max=n, num_rounds=rounds)
    return ExperimentSpec(**{**dict(
        scenarios=(scenario,), strategies=("labelwise", "random"),
        seeds=(0,), engine=engine, workload="lm-12m", fl=fl,
        eval_n_per_class=2, rounds=rounds,
        telemetry=("selected_label_hist",)), **over})


def _lm_fl_pair(np, spec, dev, what: str, ntok: int) -> dict:
    """``spec`` on the card (launch counts read around it) and on the CPU;
    selections bit-equal, loss and accuracy within LM_LOSS_REL and
    LM_ACC_TOKENS."""
    import torch
    from repro_torch import kernels
    from repro_torch.fl import run
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = run(spec, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    cpu = run(spec, device="cpu")
    sel_card = card.telemetry()["selected_label_hist"]
    sel_cpu = cpu.telemetry()["selected_label_hist"]
    loss_rel = float(np.abs(card.loss - cpu.loss).max()
                     / np.abs(cpu.loss).max())
    acc_gap = float(np.abs(card.accuracy - cpu.accuracy).max()) * ntok
    say(f"{what}: launches {launches}; {wall:.1f} s on the card; eval loss "
        f"card {card.loss.reshape(-1, card.loss.shape[-1]).tolist()} vs CPU "
        f"gap {loss_rel:.2e} relative, accuracy gap {acc_gap:.1f} of {ntok} "
        f"tokens; selections "
        f"{'bit-equal' if np.array_equal(sel_card, sel_cpu) else 'DIFFER'}")
    if not (np.array_equal(card.num_selected, cpu.num_selected)
            and np.array_equal(sel_card, sel_cpu)):
        raise AssertionError(f"{what}: selections differ card vs CPU")
    if not (loss_rel <= LM_LOSS_REL and acc_gap <= LM_ACC_TOKENS
            and np.isfinite(card.loss).all()):
        raise AssertionError(f"{what}: loss gap {loss_rel}, accuracy gap "
                             f"{acc_gap} tokens")
    return {"launches": launches, "loss_rel": loss_rel, "acc_gap": acc_gap,
            "wall_s": wall}


def phase16e_lm_fl(dev) -> dict:
    """The lm FL workload through run: the example's spec on sim and host,
    the registered micro lm, and fl-lm-12m at the paper's FL width."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import FLConfig
    from repro_torch.fl import lm_workload, register_workload, run
    from repro_torch.models.config import ModelConfig
    say("== 16e. the lm FL workload through run (card against CPU, TF32 "
        "off)")
    old = _tf32(False, False)
    register_workload("lm-12m", lm_workload(ModelConfig(**FL_LM_CFG),
                                            num_domains=8, seq_len=64),
                      overwrite=True)
    out = {}
    ntok = 8 * 2 * 63          # 2 eval sequences a domain, 63 targets each
    for engine in ("sim", "host"):
        out[engine] = _lm_fl_pair(np, _lm_fl_spec(np, engine, LM_ROUNDS),
                                  dev, f"fl-lm-12m {engine}, {LM_ROUNDS} "
                                       f"rounds x (labelwise, random)", ntok)
    got = out["sim"]["launches"]
    if (got["label_hist"], got["weighted_agg"]) != (LM_ROUNDS, LM_ROUNDS):
        raise AssertionError(f"lm sim: {got}, expected {LM_ROUNDS} label_hist"
                             f" and {LM_ROUNDS} weighted_agg launches")
    micro = _lm_fl_spec(np, "sim", 2, workload="lm", domains=10,
                        fl=dict(num_clients=6, clients_per_round=3,
                                local_epochs=1, batch_size=4))
    out["micro"] = _lm_fl_pair(np, micro, dev, "registered micro lm (head "
                               "dim 16), sim, 2 rounds", 10 * 2 * 15)
    if min(out["micro"]["launches"][k] for k in
           ("flash_attention", "flash_attention_bwd")) == 0:
        raise AssertionError("the micro lm did not reach the flash kernels")
    _tf32(*old)
    # fl-lm-12m at the paper's FL width: N = 100, 30 a round, FLConfig()'s
    # epochs and batch, 32 sequences a client.
    cfg = FLConfig()
    spec = _lm_fl_spec(np, "sim", 2, strategies=("labelwise",), seqs=32,
                       fl=dict(num_clients=cfg.num_clients,
                               clients_per_round=cfg.clients_per_round,
                               local_epochs=cfg.local_epochs,
                               batch_size=cfg.batch_size, lr=cfg.lr))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = run(spec, device=dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    meta = res.meta["sim"]
    say(f"fl-lm-12m at the paper's FL width (N=100, 30 a round, 4 local "
        f"epochs of batch 32, 32 sequences of 64 a client), 2 rounds: "
        f"rounds {[f'{x:.3f}' for x in meta['round_s']]} s wall, peak "
        f"{meta['peak_bytes'] / 1e9:.2f} GB, launches {launches}, eval loss "
        f"{res.loss.reshape(-1).tolist()}")
    if not np.isfinite(res.loss).all() or (
            launches["label_hist"], launches["weighted_agg"]) != (2, 2):
        raise AssertionError(f"paper-width lm: {launches}, {res.loss}")
    out["paper"] = {"round_s": meta["round_s"],
                    "peak_bytes": meta["peak_bytes"], "launches": launches}
    return out


def _train_run(dev, arch, **kw) -> dict:
    import gc
    import torch
    from repro_torch import kernels, rng
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.train import run_train, synth_lm_batch
    for batch in (TRAIN_BATCH, TRAIN_BATCH // 2):
        gc.collect()                 # a failed attempt's tensors, if any
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        ssd_ops.vjp_calls = 0
        times, losses = [], None
        try:
            losses = run_train(arch, TRAIN_STEPS, batch, TRAIN_SEQ,
                               reduced=False, device=dev, step_times=times,
                               log_every=TRAIN_STEPS, **kw)
        except torch.cuda.OutOfMemoryError:
            say(f"{arch}: batch {batch} x {TRAIN_SEQ} ran out of memory "
                f"(peak {torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB)")
        if losses is None:
            continue
        launches = {k: v / TRAIN_STEPS
                    for k, v in kernels.launch_counts().items()}
        launches["ssd_vjp"] = ssd_ops.vjp_calls / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated(dev)
        # The step's synthetic batch alone: the categorical draw hashes
        # batch x seq x vocab gumbels.
        ds = TokenDataset(vocab_size=get_config(arch).vocab_size,
                          seq_len=TRAIN_SEQ, device=dev)
        draws = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synth_lm_batch(ds, rng.fold_in(rng.PRNGKey(0, dev), i), batch)
            torch.cuda.synchronize()
            draws.append(time.perf_counter() - t0)
        return {"losses": losses, "step_s": times, "batch": batch,
                "peak": peak, "launches": launches,
                "draw_s": statistics.median(draws)}
    raise AssertionError(f"{arch}: neither batch {TRAIN_BATCH} nor "
                         f"{TRAIN_BATCH // 2} fits the card")


def phase16f_full_width(dev) -> dict:
    """run_train at full width: mamba2-1.3b at full depth, qwen3-14b cut to
    TRAIN_QWEN_LAYERS layers."""
    import gc
    import math
    import torch
    say(f"== 16f. run_train at full width, {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    out = {}
    for arch, kw in (("mamba2-1.3b", {}),
                     ("qwen3-14b", {"num_layers": TRAIN_QWEN_LAYERS})):
        r = _train_run(dev, arch, **kw)
        warm = r["step_s"][1:]
        tok_s = r["batch"] * TRAIN_SEQ / statistics.median(warm)
        say(f"{arch} {kw or 'full depth'}: batch {r['batch']}; losses "
            f"{[round(x, 4) for x in r['losses']]}; step "
            f"{[f'{x:.3f}' for x in r['step_s']]} s (first with the "
            f"kernels' first launches), {tok_s:.0f} tokens/s warm; of a "
            f"step, the batch's token draw alone {r['draw_s']:.3f} s; peak "
            f"{r['peak'] / 1e9:.2f} GB; launches a step {r['launches']}")
        if not all(math.isfinite(x) for x in r["losses"]) \
                or not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"{arch}: losses {r['losses']}")
        out[arch] = {**r, "tokens_s": tok_s}
        gc.collect()
        torch.cuda.empty_cache()
    return out


# Phase 17: the sharded engine (fl/sharded.py) at the paper's FL width
# (FLConfig(): N = 100, 30 a round, 4 local epochs of batch 32, Adam 1e-3,
# fedavg), case1b x SHARDED_STRATEGIES x one seed, SHARDED_ROUNDS rounds.
# The machine has one card and NCCL refuses two ranks on one device, so the
# engine runs one group: once with no process group (every collective the
# identity) and once inside a one-rank NCCL group (every collective an
# NCCL call on the card's tensors); the two must be bit-identical.  Both
# are held to the card's sim run of the same spec at the reference's own
# sharded == sim pins (tests/test_experiment.py: num_selected equal, loss
# rtol SHARDED_RTOL / atol SHARDED_ATOL, accuracy atol SHARDED_ACC_ATOL).
# TF32 off and cuDNN's deterministic algorithms on, so that a difference
# can only come from the engines.
SHARDED_STRATEGIES = ("labelwise", "random")
SHARDED_ROUNDS = 2
SHARDED_RTOL, SHARDED_ATOL, SHARDED_ACC_ATOL = 2e-4, 2e-5, 5e-3


def _sharded_spec(engine: str, **kw):
    from repro_torch.configs import FLConfig
    from repro_torch.fl import ExperimentSpec, ScenarioSpec
    base = dict(scenarios=(ScenarioSpec.from_case("case1b"),),
                strategies=SHARDED_STRATEGIES, seeds=(0,), engine=engine,
                fl=FLConfig(), rounds=SHARDED_ROUNDS)
    base.update(kw)
    return ExperimentSpec(**base)


def _counted_run(dev, spec, ds=None) -> dict:
    """``run(spec)`` with the launch counts set to 0 just before and read
    just after; for ``sharded`` also each round's wall time (its
    ``sharded:round`` spans)."""
    import torch
    from repro_torch import kernels
    from repro_torch.fl import run
    from repro_torch.obs import trace
    n_ev = len(trace.events())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(spec, ds=ds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    rounds = [e["dur"] / 1e6 for e in trace.events()[n_ev:]
              if e["name"] == "sharded:round"]
    return {"res": res, "launches": launches, "wall_s": wall,
            "round_s": rounds}


def _sharded_pin(what: str, sh, sim) -> dict:
    """``sharded`` against ``sim``: num_selected equal, loss and accuracy
    within the reference's sharded == sim pins, cluster assignments
    bit-equal."""
    import numpy as np
    if not np.array_equal(sh.num_selected, sim.num_selected):
        raise AssertionError(f"{what}: num_selected differs from sim")
    loss_gap = float(np.abs(sh.loss - sim.loss).max())
    acc_gap = float(np.abs(sh.accuracy - sim.accuracy).max())
    if not (np.allclose(sh.loss, sim.loss, rtol=SHARDED_RTOL,
                        atol=SHARDED_ATOL)
            and acc_gap <= SHARDED_ACC_ATOL
            and np.isfinite(sh.loss).all()):
        raise AssertionError(f"{what}: loss {loss_gap:.3e} and accuracy "
                             f"{acc_gap:.3e} from sim, over the pins")
    cs, cr = sh.cluster_trajectories(), sim.cluster_trajectories()
    if cr is not None and not np.array_equal(cs["assign"], cr["assign"]):
        raise AssertionError(f"{what}: cluster assignments differ from sim")
    return {"loss_gap": loss_gap, "acc_gap": acc_gap,
            "loss_rel": loss_gap / float(np.abs(sim.loss).max())}


def _expect(what: str, launches: dict, label_hist: int,
            weighted_agg: int, lm: bool = False) -> None:
    got = (launches["label_hist"], launches["weighted_agg"])
    if got != (label_hist, weighted_agg) or (not lm and any(
            launches[k] for k in ("flash_attention", "flash_attention_bwd",
                                  "ssd_scan"))):
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{label_hist} label_hist and {weighted_agg} "
                             f"weighted_agg")


def phase17_sharded(dev) -> dict:
    """The sharded engine on the card: (a) the paper's FL width with no
    process group and in a one-rank NCCL group, against sim; (b)
    clustered_fedavg4 and median under poison against sim; (c) the lm
    workload against sim."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.data import ImageDataset
    from repro_torch.fl import lm_workload, register_workload
    from repro_torch.models.config import ModelConfig
    say(f"== 17a. run(ExperimentSpec(engine='sharded')) at the paper's FL "
        f"width, case1b x {SHARDED_STRATEGIES} x 1 seed, {SHARDED_ROUNDS} "
        f"rounds, against sim (TF32 off, cuDNN deterministic)")
    old = _tf32(False, False)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ds = ImageDataset(device=dev)
    per_run = len(SHARDED_STRATEGIES) * SHARDED_ROUNDS
    out = {}
    sim = _counted_run(dev, _sharded_spec("sim"), ds)
    alone = _counted_run(dev, _sharded_spec("sharded"), ds)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        nccl = _counted_run(dev, _sharded_spec("sharded"), ds)
    finally:
        dist.destroy_process_group()
    cfg = _sharded_spec("sharded").fl
    want_facts = (1, cfg.clients_per_round,
                  1.0 - cfg.clients_per_round / cfg.num_clients)
    for what, r in (("no process group", alone), ("one-rank NCCL", nccl)):
        _expect(f"sharded, {what}", r["launches"], per_run, per_run)
        st = r["res"].meta["sharded"]
        facts = st["strategies"]["labelwise"]
        if (st["groups"], facts["budget"],
                facts["flop_sparsity"]) != want_facts:
            raise AssertionError(f"sharded, {what}: meta {st}, expected "
                                 f"(groups, budget, flop_sparsity) "
                                 f"{want_facts}")
    for name in ("accuracy", "loss", "num_selected"):
        if not np.array_equal(getattr(alone["res"], name),
                              getattr(nccl["res"], name)):
            raise AssertionError(f"sharded: {name} in the one-rank NCCL "
                                 "group differs from the run without one")
    if alone["res"].meta["sharded"] != nccl["res"].meta["sharded"]:
        raise AssertionError("sharded: meta differs with NCCL")
    pin = _sharded_pin("sharded 17a", alone["res"], sim["res"])
    sim_round = sim["res"].meta["sim"]["round_s"]
    say(f"no process group and one-rank NCCL bit-identical; launches "
        f"{alone['launches']} ({len(SHARDED_STRATEGIES)} strategies x "
        f"{SHARDED_ROUNDS} rounds: 1 label_hist and 1 weighted_agg a "
        f"strategy and round); rounds {[f'{x:.3f}' for x in alone['round_s']]}"
        f" s wall without a group, {[f'{x:.3f}' for x in nccl['round_s']]} s "
        f"in the NCCL group (both strategies a round); sim's rounds "
        f"{[f'{x:.3f}' for x in sim_round]} s (both strategies as 2 trials); "
        f"against sim: loss {pin['loss_gap']:.3e} ({pin['loss_rel']:.3e} "
        f"relative), accuracy {pin['acc_gap']:.3e}; "
        f"meta {alone['res'].meta['sharded']['strategies']['labelwise']}")
    out["a"] = {"launches": alone["launches"], "round_s": alone["round_s"],
                "nccl_round_s": nccl["round_s"], "sim_round_s": sim_round,
                **pin}

    say("== 17b. clustered_fedavg4, and median under poison (scale -4) on a "
        "quarter of the clients, sharded against sim")
    poison = {"frac": 0.25, "behaviors": ["poison"], "scale": -4.0}
    for name, kw, agg_launches in (
            ("clustered_fedavg4", {"aggregation": "clustered_fedavg4"},
             4 * per_run),
            ("median+poison", {"aggregation": "median", "adversary": poison},
             0)):
        ref = _counted_run(dev, _sharded_spec("sim", **kw), ds)
        got = _counted_run(dev, _sharded_spec("sharded", **kw), ds)
        _expect(f"sharded {name}", got["launches"], per_run, agg_launches)
        st = got["res"].meta["sharded"]
        if name.startswith("median") and st["reduce"] != "gather":
            raise AssertionError(f"median: meta {st}")
        pin = _sharded_pin(f"sharded {name}", got["res"], ref["res"])
        say(f"{name}: launches {got['launches']}; rounds "
            f"{[f'{x:.3f}' for x in got['round_s']]} s wall (sim "
            f"{[f'{x:.3f}' for x in ref['res'].meta['sim']['round_s']]}); "
            f"against sim loss {pin['loss_gap']:.3e}, accuracy "
            f"{pin['acc_gap']:.3e}"
            + ("; cluster assignments bit-equal"
               if kw["aggregation"].startswith("clustered") else
               f"; reduce {st['reduce']}"))
        out[name] = {"launches": got["launches"], "round_s": got["round_s"],
                     **pin}

    say(f"== 17c. fl-lm-12m ({LM_ROUNDS} rounds, labelwise) sharded "
        "against sim")
    register_workload("lm-12m", lm_workload(ModelConfig(**FL_LM_CFG),
                                            num_domains=8, seq_len=64),
                      overwrite=True)
    lm = {e: _counted_run(dev, _lm_fl_spec(np, e, LM_ROUNDS,
                                           strategies=("labelwise",)))
          for e in ("sim", "sharded")}
    _expect("sharded lm", lm["sharded"]["launches"], LM_ROUNDS, LM_ROUNDS,
            lm=True)
    if min(lm["sharded"]["launches"][k] for k in
           ("flash_attention", "flash_attention_bwd")) == 0:
        raise AssertionError("sharded lm did not reach the flash kernels")
    pin = _sharded_pin("sharded lm", lm["sharded"]["res"], lm["sim"]["res"])
    say(f"fl-lm-12m sharded: launches {lm['sharded']['launches']}; rounds "
        f"{[f'{x:.3f}' for x in lm['sharded']['round_s']]} s wall; against "
        f"sim loss {pin['loss_gap']:.3e}, accuracy {pin['acc_gap']:.3e}")
    out["lm"] = {"launches": lm["sharded"]["launches"], **pin}
    torch.backends.cudnn.deterministic = det
    _tf32(*old)
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import FLConfig
    from repro_torch.core import case_label_plan
    from repro_torch.data import ImageDataset, client_batches
    from repro_torch.fl import get_workload, make_fl_round, run_fl_host
    from repro_torch.kernels import build
    from repro_torch.kernels.dispatch import client_histograms
    from repro_torch.kernels.label_hist import label_hist_kernel, label_hist_ref
    from repro_torch.kernels.label_hist.label_hist import plan_hist
    from repro_torch.kernels.dispatch import masked_weighted_mean
    from repro_torch.kernels.weighted_agg import (weighted_agg_kernel,
                                                  weighted_agg_leaves,
                                                  weighted_agg_ref)
    from repro_torch.models import cnn_init
    from repro_torch.rng import PRNGKey

    dev = torch.device("cuda")
    t_start = time.time()

    say("== 1. card")
    card = gpu_name_and_power()
    say(card)

    say("== 2. build")
    t0 = time.time()
    lib = build.build()
    build.library()
    say(f"built {lib.name} in {time.time() - t0:.1f} s")
    say(Path(str(lib) + ".log").read_text().strip())
    tensor_core_report(lib)

    say("== 3. label_hist against its plain version (bit-equal)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hist_err = 0.0
    for what, labels, valid, c in hist_cases(dev):
        got = label_hist_kernel(labels, valid, c)
        want = label_hist_ref(labels, valid, c)
        torch.cuda.synchronize()
        hist_err = max(hist_err, (got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"label_hist differs at {what}")
        plan = plan_hist(*labels.shape, c, sms)
        say(f"label_hist {what}: equal, {int(want.sum().item())} counts; "
            f"{plan.blocks} blocks of {plan.threads} threads, "
            f"{plan.team_threads} threads a row, {plan.chunks_per_row} "
            f"chunks a row")

    say("== 4. weighted_agg against its plain version")
    cfg = FLConfig()
    shapes = {k: v.shape for k, v in cnn_init(device=dev).items()}
    leaf_sizes = {k: math.prod(s) for k, s in shapes.items()}
    say(f"paper CNN leaves: {leaf_sizes}, {sum(leaf_sizes.values())} params")
    agg_err = 0.0
    for name, size in leaf_sizes.items():
        rng = np.random.default_rng(size)
        x32 = torch.from_numpy(
            0.05 * rng.standard_normal((K_CLIENTS, size)).astype(np.float32)
        ).to(dev)
        scales = torch.from_numpy(
            rng.uniform(30, 290, K_CLIENTS).astype(np.float32)).to(dev)
        # Summation-error bound for float32: both sides sum K products with
        # one rounding each, in different orders.
        mag = scales @ x32.abs()
        tol32 = 2 * K_CLIENTS * 2.0 ** -24 * mag
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype).contiguous()
            got = weighted_agg_kernel(x, scales).float()
            want = weighted_agg_ref(x, scales).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            # bfloat16: both round their float32 sum once, so they may land
            # one bfloat16 ulp (2^-7 of the value at most) apart.
            tol = (tol32 if dtype == torch.float32
                   else tol32 + 2.0 ** -7 * want.abs())
            if bool((err > tol).any()):
                raise AssertionError(f"weighted_agg {name} {dtype}: error "
                                     f"{err.max().item()} over tolerance")
            if dtype == torch.float32:
                agg_err = max(agg_err, err.max().item())
            say(f"weighted_agg {name} (K={K_CLIENTS}, N={size}) {dtype}: "
                f"max abs err {err.max().item():.3e}")
    # The whole round's tree in one call: one launch, each leaf within the
    # same float32 summation bound; as the masked mean, the sums divided by
    # the same device scalar, within that bound over Σw and one rounding.
    rng = np.random.default_rng(4)
    tree = {name: torch.from_numpy(0.05 * rng.standard_normal(
        (K_CLIENTS,) + tuple(shapes[name])).astype(np.float32)).to(dev)
        for name in leaf_sizes}
    scales = torch.from_numpy(
        rng.uniform(30, 290, K_CLIENTS).astype(np.float32)).to(dev)
    mask = torch.from_numpy(
        (rng.random(K_CLIENTS) > 0.3).astype(np.float32)).to(dev)
    flats = [x.reshape(K_CLIENTS, -1) for x in tree.values()]
    kernels.reset_launch_counts()
    sums = weighted_agg_leaves(flats, scales)
    torch.cuda.synchronize()
    tree_launches = kernels.launch_counts()["weighted_agg"]
    kernels.reset_launch_counts()
    means = masked_weighted_mean(tree, mask, scales)
    torch.cuda.synchronize()
    mean_launches = kernels.launch_counts()["weighted_agg"]
    if (tree_launches, mean_launches) != (1, 1):
        raise AssertionError(f"weighted_agg: {tree_launches} and "
                             f"{mean_launches} launches for the round's tree,"
                             f" expected 1 each")
    w = mask * scales
    denom = torch.clamp(w.sum(), min=1e-12)
    tree_err = 0.0
    for (name, x), flat, got_sum in zip(tree.items(), flats, sums):
        tol32 = 2 * K_CLIENTS * 2.0 ** -24 * (scales @ flat.abs())
        err = (got_sum - weighted_agg_ref(flat, scales)).abs()
        want = weighted_agg_ref(flat, w, denom)
        err_mean = (means[name].reshape(-1) - want).abs()
        tol_mean = (2 * K_CLIENTS * 2.0 ** -24 * (w @ flat.abs()) / denom
                    + 2.0 ** -23 * want.abs())
        if bool((err > tol32).any()) or bool((err_mean > tol_mean).any()):
            raise AssertionError(f"weighted_agg round tree, leaf {name}: "
                                 f"max |diff| {err.max().item()} (sum), "
                                 f"{err_mean.max().item()} (mean)")
        tree_err = max(tree_err, err.max().item())
        agg_err = max(agg_err, err.max().item())
    say(f"weighted_agg, the round's {len(flats)} leaves in one launch: max "
        f"abs err {tree_err:.3e}; masked_weighted_mean of the tree in one "
        f"launch, within its bound")

    say("== 5. one paper-width round on the card against the CPU")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    images, labels, valid = paper_round_inputs(np, cfg, seed=0)
    loss_fn = get_workload("cnn").make_loss(None)
    init = cnn_init(PRNGKey(0), device="cpu")
    for opt in ("sgd", "adam"):
        round_cfg = dataclasses.replace(cfg, local_epochs=ROUND_EPOCHS,
                                        optimizer=opt)
        results = {}
        for d in ("cuda", "cpu"):
            t0 = time.time()
            data = {"images": torch.from_numpy(images).to(d),
                    "labels": torch.from_numpy(labels).to(d),
                    "valid": torch.from_numpy(valid).to(d)}
            hists = client_histograms(
                torch.where(data["valid"], data["labels"], 0), 10,
                data["valid"])
            batches = client_batches(data, cfg.batch_size)
            params = {k: v.to(d) for k, v in init.items()}
            new, info = make_fl_round(loss_fn, round_cfg)(params, batches,
                                                          hists)
            if d == "cuda":
                torch.cuda.synchronize()
            results[d] = (hists.cpu(), {k: v.cpu() for k, v in new.items()},
                          {k: v.cpu() for k, v in info.items()
                           if torch.is_tensor(v)})
            say(f"{opt} {d}: round in {time.time() - t0:.2f} s, "
                f"{int(info['num_selected'])} clients trained")
        (h_gpu, p_gpu, i_gpu), (h_cpu, p_cpu, i_cpu) = (results["cuda"],
                                                        results["cpu"])
        if not torch.equal(h_gpu, h_cpu):
            raise AssertionError("round histograms differ: card vs CPU")
        for k in ("selected", "live", "mask", "num_selected"):
            if not torch.equal(i_gpu[k], i_cpu[k]):
                raise AssertionError(f"round selection {k!r} differs")
        diff = max((p_gpu[k] - p_cpu[k]).abs().max().item() for k in p_cpu)
        upd = torch.cat([(p_cpu[k] - init[k]).reshape(-1) for k in p_cpu])
        gap = torch.cat([(p_gpu[k] - p_cpu[k]).reshape(-1) for k in p_cpu])
        rel = (gap.norm() / upd.norm()).item()
        say(f"{opt}: selection bit-equal; params max |cuda - cpu| = "
            f"{diff:.3e}, |update gap| / |update| = {rel:.3e}, update "
            f"max {upd.abs().max().item():.3e}")
        if opt == "sgd" and not diff <= SGD_ATOL:
            raise AssertionError(f"sgd round params differ by {diff} > "
                                 f"{SGD_ATOL}")
        if opt == "adam" and not rel <= ADAM_REL:
            raise AssertionError(f"adam round updates differ by {rel} of "
                                 f"their norm > {ADAM_REL}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32[:2]
    torch.set_float32_matmul_precision(tf32[2])

    say("== 6. main path: run_fl_host, 3 paper-width rounds on the card")
    rounds = 3
    plan = case_label_plan("case1b", 0, rounds, cfg.num_clients)
    ds = ImageDataset(device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hist = run_fl_host(plan, cfg, strategy="labelwise", aggregation="fedavg",
                       rounds=rounds, ds=ds, device=dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for t in range(rounds):
        say(f"round {t + 1}: acc={hist.accuracy[t]:.4f} "
            f"loss={hist.loss[t]:.4f} nsel={hist.num_selected[t]:.0f}")
    say(f"wall_s={hist.wall_s:.3f} launches={launches}")
    want = {"label_hist": rounds, "weighted_agg": rounds,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "ssd_scan": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not all(math.isfinite(v) for v in hist.accuracy + hist.loss):
        raise AssertionError("non-finite trajectory")
    if hist.num_selected != [float(cfg.clients_per_round)] * rounds:
        raise AssertionError(f"selected {hist.num_selected}")

    say("== 7. kernel times at the main path's shapes (device time per call)")
    lab = torch.from_numpy(labels).to(dev)
    val = torch.from_numpy(valid).to(dev)
    lab0 = torch.where(val, lab, 0)
    b, n = lab.shape
    c = 10
    counted = float(label_hist_ref(lab0, val, c).sum().item())
    flat = torch.arange(b, device=dev)[:, None] * c + lab0.long()
    flat = torch.where(val, flat, b * c).reshape(-1)
    hist_times = label_hist_times(dev, label_hist_kernel, (lab0, val, c))
    hist_ms = hist_times["main_ms"]
    hist_plain = time_ms(lambda: label_hist_ref(lab0, val, c))
    hist_lib = time_ms(lambda: torch.bincount(flat, minlength=b * c + 1))
    hist_bound, hist_by = bound(lab0.numel() * 4 + val.numel() + b * c * 4,
                                counted)
    say(f"label_hist (B={b}, n={n}, C={c}): kernel {hist_ms:.4f} ms, bound "
        f"{hist_bound:.6f} ms ({hist_by}), plain {hist_plain:.4f} ms, "
        f"bincount {hist_lib:.4f} ms")
    say_label_hist_times(hist_times)

    agg = dict.fromkeys(("plain", "lib", "bytes", "ops"), 0.0)
    xs = [torch.from_numpy(np.random.default_rng(size).standard_normal(
        (K_CLIENTS, size)).astype(np.float32)).to(dev)
        for size in leaf_sizes.values()]
    w = torch.from_numpy(np.random.default_rng(K_CLIENTS).uniform(
        30, 290, K_CLIENTS).astype(np.float32)).to(dev)
    for name, x in zip(leaf_sizes, xs):
        size = x.shape[1]
        k_ms = time_ms(lambda: weighted_agg_kernel(x, w))
        p_ms = time_ms(lambda: weighted_agg_ref(x, w))
        l_ms = time_ms(lambda: w @ x)
        nbytes = (K_CLIENTS * size + K_CLIENTS + size) * 4
        leaf_bound, _ = bound(nbytes, 2 * K_CLIENTS * size)
        for key, v in (("plain", p_ms), ("lib", l_ms), ("bytes", nbytes),
                       ("ops", 2 * K_CLIENTS * size)):
            agg[key] += v
        say(f"weighted_agg {name} (K={K_CLIENTS}, N={size}), one leaf: "
            f"kernel {k_ms:.4f} ms, bound {leaf_bound:.5f} ms, "
            f"plain {p_ms:.4f} ms, s @ stacked {l_ms:.4f} ms")
    agg["ms"] = time_ms(lambda: weighted_agg_leaves(xs, w))
    agg_bound, agg_by = bound(agg["bytes"], agg["ops"])
    say(f"weighted_agg, one round's {len(leaf_sizes)} leaves in one launch: "
        f"kernel {agg['ms']:.4f} ms, bound {agg_bound:.5f} ms ({agg_by}, "
        f"{agg['bytes'] / 1e6:.1f} MB); per leaf summed: plain "
        f"{agg['plain']:.4f} ms, s @ stacked {agg['lib']:.4f} ms")

    flash_err = phase8_flash(dev)
    ssd_err = phase9_ssd(dev)
    phase10_serve_card_vs_cpu(dev)
    served = phase11_serve(dev)
    times = phase12_times(dev)
    fa, ssd = times["flash_attention"], times["ssd_scan"]
    phase13a_threefry(dev)
    grid = phase13b_grid(dev)
    phase13c_grid_vs_host(dev)
    axis = phase13d_trial_axis(dev)
    ta, eh = axis["weighted_agg"], axis["label_hist"]
    p14 = phase14ab_grid(dev, grid["round_s"][-1])
    phase14c_vs_host(dev)
    p14d = phase14d_card_vs_cpu(dev, p14["trials"])
    clus = p14["clustered"]
    p15 = phase15ab_engines(dev)
    p15c = phase15c_population(dev)
    p15d = phase15d_kernels(dev)
    pop_hist, pop_agg = p15d["label_hist"], p15d["weighted_agg"]
    bwd = phase16a_flash_backward(dev)
    p16bd = phase16bd_gradients(dev)
    phase16c_vmap_grad(dev)
    p16e = phase16e_lm_fl(dev)
    p16f = phase16f_full_width(dev)
    p17 = phase17_sharded(dev)

    say(f"card: {card}; total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "label_hist", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/label_hist.cu",
         "replaces": "src/repro/kernels/label_hist/label_hist.py:37",
         "launches": launches["label_hist"], "max_abs_err": hist_err,
         "ms": hist_ms, "plain_ms": hist_plain, "bound_ms": hist_bound,
         "bound_by": hist_by, "library_ms": hist_lib,
         "floor_ms": hist_times["floor_ms"],
         "grid_ms": hist_times["grid"]["cold_ms"],
         "engine_grid_launches": grid["launches"]["label_hist"],
         "engine_grid_shape": eh["shape"], "engine_grid_ms": eh["ms"],
         "engine_grid_plain_ms": eh["plain"],
         "engine_grid_bound_ms": eh["bound"],
         "engine_grid_library_ms": eh["lib"],
         "hier_launches": p15["hier"]["launches"]["label_hist"],
         "async_launches": p15["async"]["launches"]["label_hist"],
         "population_launches": {str(n): r["launches"]
                                 for n, r in p15c["rows"].items()},
         "population_shapes": [[r, POP_SPC, 10] for r in pop_hist],
         "population_ms": [h["ms"] for h in pop_hist.values()],
         "population_plain_ms": [h["plain"] for h in pop_hist.values()],
         "population_bound_ms": [h["bound"] for h in pop_hist.values()],
         "population_library_ms": [h["lib"] for h in pop_hist.values()],
         "sharded_launches": p17["a"]["launches"]["label_hist"],
         "sharded_clustered_launches":
             p17["clustered_fedavg4"]["launches"]["label_hist"],
         "sharded_lm_launches": p17["lm"]["launches"]["label_hist"]},
        {"name": "weighted_agg", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/weighted_agg.cu",
         "replaces": "src/repro/kernels/weighted_agg/weighted_agg.py:28",
         "launches": launches["weighted_agg"], "max_abs_err": agg_err,
         "ms": agg["ms"], "plain_ms": agg["plain"], "bound_ms": agg_bound,
         "bound_by": agg_by, "library_ms": agg["lib"],
         "trial_axis_launches": grid["launches"]["weighted_agg"],
         "trial_axis_max_abs_err": ta["err"], "trial_axis_ms": ta["ms"],
         "trial_axis_plain_ms": ta["plain"],
         "trial_axis_bound_ms": ta["bound"],
         "trial_axis_library_ms": ta["lib"],
         "clustered_launches": clus["launches"]["weighted_agg"],
         "clustered_ms": p14d["clustered_ms"],
         "clustered_bound_ms": p14d["clustered_bound_ms"],
         "clustered_design_traffic_ms": p14d["clustered_design_traffic_ms"],
         "async_launches": p15["async"]["launches"]["weighted_agg"],
         "async_shape": pop_agg["shape"], "async_ms": pop_agg["ms"],
         "async_max_abs_err": pop_agg["err"],
         "async_plain_ms": pop_agg["plain"],
         "async_bound_ms": pop_agg["bound"],
         "async_library_ms": pop_agg["lib"],
         "sharded_launches": p17["a"]["launches"]["weighted_agg"],
         "sharded_clustered_launches":
             p17["clustered_fedavg4"]["launches"]["weighted_agg"],
         "sharded_lm_launches": p17["lm"]["launches"]["weighted_agg"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:82",
         "launches": served["qwen3-14b"]["launches"],
         "max_abs_err": flash_err, "ms": fa["ms"], "plain_ms": fa["plain"],
         "bound_ms": fa["bound"], "bound_by": fa["by"],
         "library_ms": fa["lib"], "lse_ms": fa["lse_ms"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:71",
         "launches": served["mamba2-1.3b"]["launches"],
         "max_abs_err": ssd_err, "ms": ssd["ms"], "plain_ms": ssd["plain"],
         "bound_ms": ssd["bound"], "bound_by": ssd["by"],
         "library_ms": ssd["lib"],
         "train_launches": p16f["mamba2-1.3b"]["launches"]["ssd_scan"],
         "backward_plain_vjp_ms": p16bd["ssd_bwd_ms"],
         "backward_grad_gap": p16bd["ssd_grad_gap"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:82"
                     " (no TPU backward kernel: the reference differentiates"
                     " XLA attention)",
         "launches": int(p16f["qwen3-14b"]["launches"]["flash_attention_bwd"]
                         * TRAIN_STEPS),
         "max_abs_err": bwd["err"], "ms": bwd["ms"], "plain_ms": bwd["plain"],
         "bound_ms": bwd["bound"], "bound_by": bwd["by"],
         "library_ms": bwd["lib"], "f32_pair_ms": bwd["f32_ms"],
         "fl_launches": p16e["sim"]["launches"]["flash_attention_bwd"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
