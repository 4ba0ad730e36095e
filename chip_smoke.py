#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and print the build time and the compiler's register report;
   check from ``cuobjdump -sass`` that the bf16 flash kernels (the forward
   and the backward's dQ and dK/dV kernels), both SSD scan kernels and the
   SSD backward's state and chunk kernels run on the tensor cores
   (``HGMMA``, ``HMMA``) and from the ``-Xptxas -v`` log that they spill
   nothing;
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
   both shapes without the causal mask), at head_dim 192 (nemotron-4-340b)
   in both dtypes (BH=48, S=1024, causal and window=256; S=1000, 333 and
   77, with and without the mask), and through the GQA wrapper at
   (4, 1024, 40, 128) x (4, 1024, 8, 128), (2, 333, 40, 128) x
   (2, 333, 8, 128), nemotron's group of 12 at (4, 1024, 96, 192) and
   (2, 333, 96, 192) (and float32 at S=333), arctic-480b's group of 7 at
   (4, 1024, 56, 128) (and float32 at S=333); float32 (the tensor-core
   kernels in split TF32) at every head_dim 16 to 192, causal, windowed
   and not causal at S=333, and through the GQA wrapper with groups of 8
   and 1;
9. hold ``ssd_scan`` (``ssd_apply``) against its plain version on the card at
   mamba2-1.3b's prefill shape (b=4, S=1024, H=64, P=64, G=1, N=128), at
   jamba-v0.1-52b's (4, 1024, 128, 64, 1, 16), at reduced shapes and on a
   long, strongly decaying sequence (S=2048, dt up to 10, A near -10);
10. serve every arch of ``ARCH_IDS`` (all ten) at
    ``reduced(dtype="float32")`` on the card and on the CPU from the same
    weights, tokens and stub patch or frame embeddings, TF32 off: one
    ``flash_attention`` launch an attention layer (whisper-tiny's encoder
    layers too) and one ``ssd_scan`` a Mamba layer, prefill logits, every
    cache (the cross caches too) and every decode step's logits within
    ``SERVE_TOL``;
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
    backward (output bit-identical); then the bf16 forward at
    nemotron-4-340b's prefill (4, 1024, 96/8, 192) and ``ssd_scan`` at
    jamba-v0.1-52b's, each beside its bound, its plain version and (for
    attention) SDPA; the float32 forward at ``F32_SHAPES`` (qwen3-14b's
    prefill, the lm round at the paper's FL width, the micro lm), held
    within ``FLASH_F32_TOL`` of its plain version there, then timed beside
    its bound, its plain version and SDPA in float32;
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
    33 and 40, no causal mask, and whisper-tiny's full-width training
    shapes (16, 1500, 6/6, 64) non-causal and (16, 448, 6/6, 64) causal;
    float32, the tensor-core kernels in split TF32, at every head_dim 16 to
    192, GQA groups 1, 2, 3, 5 and 8, ragged S, windows, no causal mask),
    each within ``BWD_TOL`` of its max |grad| of the plain backward and of
    a float64 plain backward, with the plain backward's own error against
    float64 printed beside it; the float32 backward's repeat calls
    bit-identical (``F32_REPEATS``); the bf16 kernels' time at qwen3-14b's
    shape beside their bound, the plain backward, SDPA's backward and the
    float32 kernels at the same shape; the float32 kernels at
    ``F32_SHAPES`` (qwen3-14b's, the lm round's, the micro lm's), held
    within ``BWD_TOL`` of the plain and the float64 backward there, then
    timed beside their bound, the plain backward and SDPA's float32
    backward, with each kernel's time (``torch.profiler``); (b) the SSD
    Function's gradients at mamba2-1.3b's widths, card against CPU, then
    ``ssd_scan_bwd`` against the plain vjp and a float64 one at
    ``SSD_BWD_SHAPES`` (mamba2-1.3b's and jamba-v0.1-52b's shapes, three
    heads a group, P 4 and 68, N 16 and 72, S 16 and 1000, phase 9's
    strongly decaying S = 2048) within ``SSD_BWD_TOL``, two calls
    bit-identical, and its time at both full shapes beside its bound and the
    plain vjp, with each of its kernels' time (``torch.profiler``), its
    scratch and its kernels' own tensor-core work; (c) ``vmap(grad)`` of a reduced LM over 6 clients: equal
    to 6 separate calls and one flash launch each way a layer; (d) the
    model's gradients card against CPU (the attention and SSD branches
    carry their gradients; one ``ssd_scan_bwd`` launch a Mamba layer and no
    plain vjp); (e) the ``lm`` FL workload through ``run``:
    examples/fl_lm_pretrain.py's spec for 3 rounds on ``sim`` (1
    ``label_hist`` and 1 ``weighted_agg`` launch a round) and ``host``, the
    registered micro ``lm`` (head_dim 16) for 2 rounds, each card against
    CPU with selections bit-equal, then fl-lm-12m at the paper's FL width
    (N = 100, 30 a round) with its wall a round and peak memory; (f)
    ``run_train`` at full width, mamba2-1.3b at full depth and qwen3-14b cut
    to 4 layers, 5 steps of 4 x 1024 tokens: step time, tokens/s, the
    token draw's share, peak memory and launches a step under the
    configs' remat (``full``: mamba2-1.3b 96 ``ssd_scan``, the forward
    and the recompute, and 48 ``ssd_scan_bwd``, no plain vjp; qwen3-14b 8
    ``flash_attention`` and 4 ``flash_attention_bwd``); losses finite and
    the last below the first.
19. the launch tooling: (a) mamba2-1.3b's full-width bf16 params saved
    from the card (``ckpt.save_checkpoint``) and loaded back onto it
    (``load_checkpoint``), bit-equal, with the GB and the times, then
    ``run_train(..., ckpt_dir=...)`` on a reduced config and its sidecar's
    ``extra``; (b) ``make_prefill_step`` / ``make_serve_step`` for
    mamba2-1.3b and qwen3-14b at phase 11's 4 x 1024 in bf16: tokens
    bit-equal to ``prefill``'s / ``decode_step``'s argmax on the same
    weights, 48 ``ssd_scan`` / 40 ``flash_attention`` launches in the
    prefill step and none in the serve step, the prefill step timed warm
    with its peak memory; (c) the dry-run (traced over fake tensors in a
    background process that starts before the build, see DRYRUN_SCRIPT) of
    those prefill steps and of phase 16f's train steps: the model's FLOPs
    (2/6·N·D) over the measured time as TFLOP/s and as a share of 989
    TFLOP/s (MFU), the traced FLOPs (a rematerialised train step's
    recompute included) over the same time beside them, the estimated
    peak beside ``max_memory_allocated``, and the traced kernel ops equal
    to the card's launches; (d) one warm step of every assigned
    prefill or decode pair that the dry-run marks ``fits_one_card`` (a
    serve step reads a full cache), with wall, peak and the estimate; an
    out-of-memory there fails the phase.  The train_4k pairs are not
    traced here (5-10 minutes of host CPU each, to read that they do not
    fit): ``python -m repro_torch.launch.dryrun --all`` records them.
20. the arch zoo at full width in bf16 with weights from a seed, each arch
    cut in depth where its weights do not fit the card (``ZOO_LAYERS``:
    qwen2-72b 8 layers, nemotron-4-340b 2, arctic-480b 1, jamba-v0.1-52b
    8 = one period of its pattern; minitron-4b and granite-moe-1b-a400m
    whole), one at a time, each freed before the next: ``run_serve(batch=4,
    prompt_len=1024, gen=16, num_layers=...)`` with capacity routing, its
    prefill and decode times, peak memory and launches (one
    ``flash_attention`` an attention layer and one ``ssd_scan`` a Mamba
    layer in the prefill, none in decode); then prefill ≡ forward and one
    decode step ≡ forward on seed-11 weights and a 200-token prompt, the
    MoE archs with ``moe_dropless`` (capacity routing drops other
    assignments in a decode step than in a forward, by design), held to
    ``SELF_TOL_BF16``; then ``run_train`` of granite-moe-1b-a400m at full
    width and depth, 5 steps of 4 x 1024 under its config's remat: finite
    losses, step time, tokens/s, peak, one ``flash_attention_bwd`` and two
    ``flash_attention`` launches an attention layer a step (the forward
    and its recompute), and its remat-on against remat-off gradient gap
    (capacity routing's ``index_add`` sums in no fixed order on the card,
    so the two are not held bit-equal: the gap is printed beside the
    remat-off step's own run-to-run gap).
21. the VLM and audio pathways: (a) ``flash_attention`` at
    phi-3-vision-4.2b's prefill (4, 2048, 32/32, 96) causal and at
    whisper-tiny's encoder (16, 1500, 6/6, 64) without the causal mask,
    each in bf16 and float32 against its plain version, the bf16 kernel
    timed beside its bound, the plain version and SDPA; (b)
    ``run_serve("phi-3-vision-4.2b", batch=4, prompt_len=1024, gen=16,
    reduced=False)`` (1024 patches before 1024 tokens, 32 layers) and (c)
    ``run_serve("whisper-tiny", batch=16, prompt_len=448, gen=16,
    reduced=False)`` (1500 frames), with the launch counts set to 0 just
    before and read just after (one ``flash_attention`` an attention layer
    of the prefill, the encoder's 4 non-causal; none in decode), then
    prefill ≡ forward and one decode step ≡ forward in bf16
    (``MODAL_SELF_TOL_BF16``) and in float32 on the weights cast up; (d)
    whisper-tiny's reduced gradients card against CPU and ``run_train`` at
    full width and depth, 5 steps of 16 x 448: finite, falling losses,
    step time, tokens/s, the batch draw's share, peak, launches a step; (e)
    the dry-run's verdicts for both archs at long_500k, decode_32k and
    prefill_32k (traced in the background), and one warm step of each pair
    it marks fits_one_card.
22. the reference's activation rematerialisation (``cfg.remat``,
    ``remat_policy`` full | dots) at full width, mamba2-1.3b at full depth
    and qwen3-14b cut to 4 layers: (a) one train step's gradients at
    4 x 1024 from the same params and batch without remat (twice: run to
    run), under ``full`` and under ``dots``, with the launch counts set to
    0 just before and read just after each: bit-equal to remat off where
    the step without remat is bit-equal to itself (else within
    ``REMAT_NOISE`` times its run-to-run gap), each kernel's forward
    launched twice a layer under either policy (the recompute) and its
    backward once, no plain vjp, each step's time and
    ``max_memory_allocated``, a lower peak under ``full``; (b) 2 train
    steps of each at 4 x 4096 under ``full``: finite losses, the peak and
    the launches a step; then one step without remat at that shape, its
    peak or its out-of-memory error printed; (c) phase 20's
    granite-moe-1b-a400m remat gap.

Without a CUDA device, without the checkout's ``src/repro_torch`` beside
this file, or with ``REPRO_COMPUTE_BACKEND`` set, the script exits non-zero
and prints no result.

The line before the last is a JSON object with each kernel's numbers
(``label_hist``'s also ``floor_ms``, the synthetic grid's cold ``grid_ms``,
phase 13's ``engine_grid_*`` and phase 15's ``hier_launches``,
``async_launches`` and ``population_*``; ``weighted_agg``'s also phase 13's
``trial_axis_*``, phase 14's ``clustered_*`` and phase 15's ``async_*``;
``ssd_scan``'s phase 16's ``train_launches`` and ``backward_grad_gap``;
phase 22's ``remat_launches`` (a step's forward launches without remat and
under each policy) and ``remat_long_launches`` (at 4 x 4096), as
``flash_attention``'s;
``flash_attention``'s phase 12's ``lse_ms``, its ``d192_*`` times at
nemotron-4-340b's shape and phase 20's ``zoo_launches``, phase 21's
``d96_*`` (phi-3-vision-4.2b's prefill shape) and ``noncausal_*``
(whisper-tiny's encoder), ``modal_launches`` and
``audio_train_launches``; ``ssd_scan``'s
``jamba_*`` times and phase 20's ``jamba_launches``; the backward kernels
``flash_attention_bwd``, its ``launches`` those of phase 16f's qwen3-14b
run, ``fl_launches`` phase 16e's sim run, ``zoo_train_launches`` phase
20's granite-moe run, ``audio_train_launches`` phase 21d's whisper-tiny
run and ``f32_ms`` the float32 kernels at the same shape;
``ssd_scan_bwd``, its ``launches`` those of phase 16f's mamba2-1.3b run,
its times at mamba2-1.3b's shape and ``jamba_*`` at jamba-v0.1-52b's; and
the float32 kernels ``flash_attention_f32`` and ``flash_attention_f32_bwd``
(split TF32), their ``launches`` those of phase 16e's paper-width lm run,
their times at the lm round's shape and ``qwen_*`` and ``micro_*`` at
qwen3-14b's and the micro lm's, phases 12 and 16a); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import dataclasses
import itertools
import json
import math
import os
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
# Phase 20: the six archs of the arch zoo at full width in bf16, their depth
# cut (num_layers) where the weights do not fit the card (PERF.md §4; None:
# full depth), and the one trained at full width and depth.
ZOO_LAYERS = {"minitron-4b": None, "granite-moe-1b-a400m": None,
              "qwen2-72b": 8, "nemotron-4-340b": 2, "arctic-480b": 1,
              "jamba-v0.1-52b": 8}
ZOO_TRAIN = "granite-moe-1b-a400m"
# Phase 20's decode ≡ forward checks, as phase 11's below (max |diff| / (1
# + |forward|) of the logits, prompt 200, seed 11), the MoE archs with
# moe_dropless on the same weights: capacity routing drops other
# assignments in a 2-token decode step than in a 402-token forward, by
# design.  Every arch in bf16; the MoE archs also in float32 on the same
# weights cast up (TF32 off, held to SELF_TOL_F32), where a fault of the
# MoE shows: in bf16 a call's
# row count changes cuBLAS's rounding of the hidden states by an ulp, and
# where two experts' router probabilities lie that close, the token routes
# to another expert.  granite-moe-1b-a400m (24 MoE layers, top 8 of 32)
# meets such near-ties in every call, so its bf16 gaps are of the logits'
# own size and have no limit; the other limits are set from the sound
# readings of scripts/torch_serve_drift.py --zoo on H100 80GB HBM3 (PERF.md
# §6), above which its faults lie.
ZOO_SELF_DTYPES = {"minitron-4b": ("bfloat16",),
                   "granite-moe-1b-a400m": ("bfloat16", "float32"),
                   "qwen2-72b": ("bfloat16",),
                   "nemotron-4-340b": ("bfloat16",),
                   "arctic-480b": ("bfloat16", "float32"),
                   "jamba-v0.1-52b": ("bfloat16", "float32")}
ZOO_SELF_TOL_BF16 = {
    "minitron-4b": {"prefill": 1e-2, "decode": 0.05},
    "qwen2-72b": {"prefill": 0.03, "decode": 0.05},
    "nemotron-4-340b": {"prefill": 0.03, "decode": 0.05},
    "arctic-480b": {"prefill": 0.03, "decode": 0.06},
    "jamba-v0.1-52b": {"prefill": 1e-2, "decode": 0.09}}
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
                 "mamba2-1.3b": {"prefill": 1e-2, "decode": 0.13},
                 **ZOO_SELF_TOL_BF16}
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


_START = time.time()


def say(msg: str) -> None:
    if msg.startswith("== "):      # a phase's header: the time so far
        msg = f"{msg} [{time.time() - _START:.1f} s]"
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


# The float32 head_dims the attention kernels take (the tensor-core kernels
# in split TF32, forward and backward).
F32_DIMS = ("16", "32", "64", "96", "128", "192")
# Kernels that must run on the tensor cores: name in the SASS, the
# instruction that shows it, and the template arguments printed beside it.
# The last entry, where given, lists the first template argument's values
# that must be instantiated.
TENSOR_CORE_KERNELS = (("flash_attention_wgmma", "HGMMA", ("D",),
                        ("64", "96", "128", "192")),
                       ("flash_bwd_dq_wgmma", "HGMMA", ("D",),
                        ("64", "96", "128", "192")),
                       ("flash_bwd_dkv_wgmma", "HGMMA", ("D",),
                        ("64", "96", "128", "192")),
                       ("flash_fwd_tf32", "HGMMA", ("D",), F32_DIMS),
                       ("flash_bwd_dq_tf32", "HGMMA", ("D",), F32_DIMS),
                       ("flash_bwd_dkv_tf32", "HGMMA", ("D",), F32_DIMS),
                       ("ssd_chunk_kernel", "HGMMA", ("NP", "HPB")),
                       ("ssd_prep_kernel", "HMMA", ("NP",)),
                       ("ssd_bwd_prep_kernel", "HMMA", ("NP",),
                        ("16", "32", "64", "128")),
                       ("ssd_bwd_walk_kernel", "HGMMA", ("NP", "HPB"),
                        ("16", "32", "64", "128")),
                       ("ssd_bwd_group_kernel", "HGMMA", ("NP",),
                        ("16", "32", "64", "128")))


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
    for kernel, instr, args, *expect in TENSOR_CORE_KERNELS:
        names = sorted(n for n in lines if kernel in n)
        if not names or names != sorted(n for n in ptxas if kernel in n):
            raise AssertionError(f"{kernel}: SASS functions {names} do not "
                                 f"match the ptxas log's")
        firsts = {re.findall(r"Li(\d+)E", n)[0] for n in names}
        if expect and not set(expect[0]) <= firsts:
            raise AssertionError(f"{kernel}: instantiations {sorted(firsts)}"
                                 f", expected {expect[0]}")
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


def phase8_flash(dev) -> tuple:
    """flash_attention against its plain version; returns the max abs error
    over all cases and over the float32 ones."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     gqa_attention_ref,
                                                     gqa_flash_attention)
    say("== 8. flash_attention against its plain version")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain versions
    g = torch.Generator(device=dev).manual_seed(8)
    worst = worst_f32 = 0.0
    cases = [((160, 1024, 128), torch.bfloat16, True, 0),
             ((160, 1024, 128), torch.bfloat16, True, 256),
             ((8, 77, 64), torch.float32, True, 0),
             ((8, 77, 64), torch.bfloat16, True, 0),
             ((8, 1000, 128), torch.bfloat16, True, 0),
             ((8, 1000, 128), torch.bfloat16, True, 256),
             ((8, 77, 64), torch.bfloat16, False, 0),
             ((8, 1000, 128), torch.bfloat16, False, 0)]
    # head_dim 192 (nemotron-4-340b), three 64-column slabs: causal, windowed,
    # without the mask and at an S that is no multiple of either tile.
    cases += [((48, 1024, 192), dtype, causal, window)
              for dtype in (torch.bfloat16, torch.float32)
              for causal, window in ((True, 0), (True, 256))]
    cases += [((8, 1000, 192), torch.bfloat16, True, 0),
              ((8, 333, 192), torch.bfloat16, True, 40),
              ((8, 333, 192), torch.float32, True, 40),
              ((8, 1000, 192), torch.bfloat16, False, 0),
              ((8, 77, 192), torch.float32, False, 0)]
    # float32 (the tensor-core kernels in split TF32) at every head_dim:
    # causal, windowed and not causal, at an S of no multiple of their
    # 16- to 128-row tiles.
    cases += [((6, 333, d), torch.float32, causal, window)
              for d in (16, 32, 64, 96, 128, 192)
              for causal, window in ((True, 0), (True, 40), (False, 0))]
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
        if dtype == torch.float32:
            worst_f32 = max(worst_f32, err.max().item())
        say(f"flash_attention {shape} {dtype} causal={causal} window={window}"
            f": max abs err {err.max().item():.3e}")
    # GQA: qwen3-14b's group of 5; nemotron-4-340b's 96 q-heads over 8
    # (12) at head_dim 192; arctic-480b's 56 over 8 (7) at 128.
    for b, s, h, kvh, d, dtype in [
            (4, 1024, 40, 8, 128, torch.bfloat16),
            (2, 333, 40, 8, 128, torch.bfloat16),
            (4, 1024, 96, 8, 192, torch.bfloat16),
            (2, 333, 96, 8, 192, torch.bfloat16),
            (1, 333, 96, 8, 192, torch.float32),
            (4, 1024, 56, 8, 128, torch.bfloat16),
            (1, 333, 56, 8, 128, torch.float32)] + [
            # float32 at every head_dim, GQA groups of 8 and 1.
            (2, 333, h, kvh, d, torch.float32)
            for d in (16, 32, 64, 96, 128, 192)
            for h, kvh in ((16, 2), (4, 4))]:
        q = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((b, s, kvh, d), generator=g,
                            device=dev).to(dtype) for _ in range(2))
        got = gqa_flash_attention(q, k, v).float()
        want = gqa_attention_ref(q, k, v).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        tol = (FLASH_F32_TOL * (1 + want.abs()) if dtype == torch.float32
               else 2.0 ** -7 * want.abs() + 1e-5)
        if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"gqa_flash_attention {(b, s, h, d)} "
                                 f"{dtype}: max |diff| {err.max().item()}")
        worst = max(worst, err.max().item())
        if dtype == torch.float32:
            worst_f32 = max(worst_f32, err.max().item())
        say(f"gqa_flash_attention {(b, s, h, d)} x {(b, s, kvh, d)} {dtype}: "
            f"max abs err {err.max().item():.3e}")
    return worst, worst_f32


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
            (4, 1024, 128, 64, 1, 16, 128, False),    # jamba-v0.1-52b's
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
        extra = modality_batch(cfg, 2, seed=10)
        runs = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            p = _tree_to(params, d)
            t = toks.to(d)
            kernels.reset_launch_counts()
            with torch.inference_mode():
                logits, caches = prefill(
                    p, cfg, {"tokens": t[:, :prompt],
                             **_tree_to(extra, d)},
                    prompt + gen + patch_tokens(cfg))
                steps = [logits]
                snap = [_tree_to(caches, "cpu")]
                for i in range(prompt, prompt + gen):
                    logits, caches = decode_step(p, cfg, t[:, i], caches)
                    steps.append(logits)
                snap.append(_tree_to(caches, "cpu"))
            counts = kernels.launch_counts()
            runs[side] = ([x.cpu() for x in steps], snap, counts)
        want = mixer_launches(cfg)
        got = {k: runs["card"][2][k] for k in want}
        if got != want:
            raise AssertionError(f"{arch}: {runs['card'][2]} launches on the "
                                 f"card, expected {want}")
        (s_gpu, c_gpu, _), (s_cpu, c_cpu, _) = runs["card"], runs["cpu"]
        gaps = [_assert_close(f"{arch} logits step {i}", a, b, SERVE_TOL)
                for i, (a, b) in enumerate(zip(s_gpu, s_cpu))]
        cache_gap = 0.0
        for when, (cg, cc) in enumerate(zip(c_gpu, c_cpu)):
            for layer, (lg, lc) in enumerate(zip(cache_layers(cg),
                                                 cache_layers(cc))):
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


def mixer_launches(cfg) -> dict:
    """The kernel launches of one prefill or forward of ``cfg``: one
    ``flash_attention`` an attention layer (an encoder-decoder's encoder
    layers too, non-causal), one ``ssd_scan`` a Mamba layer."""
    kinds = [mixer for mixer, _ in cfg.layer_kinds()]
    return {"flash_attention": kinds.count("attn") + cfg.encoder_layers,
            "ssd_scan": kinds.count("mamba")}


def train_launches(cfg) -> dict:
    """The kernel launches of one train step of ``cfg`` in one microbatch:
    each mixer layer's kernel forward once, and once more where the stack
    rematerialises (``cfg.remat`` and more than one superblock: the
    recompute in the backward), its backward kernel once."""
    from repro_torch.models.transformer import stack_plan
    fwd = mixer_launches(cfg)
    again = 2 if cfg.remat and stack_plan(cfg)[2] > 1 else 1
    return {"flash_attention": again * fwd["flash_attention"],
            "flash_attention_bwd": fwd["flash_attention"],
            "ssd_scan": again * fwd["ssd_scan"],
            "ssd_scan_bwd": fwd["ssd_scan"]}


def patch_tokens(cfg) -> int:
    """Positions a VLM's patches take before its text in the caches and the
    logits."""
    return cfg.num_patch_tokens if cfg.arch_type == "vlm" else 0


def modality_batch(cfg, b: int, seed: int, device="cpu") -> dict:
    """The stub frontend inputs of a batch of ``b`` on ``device``, drawn as
    the launchers draw them (``data.modality_inputs``) under
    ``PRNGKey(seed)``: a VLM's ``patch_embeds``, an encoder-decoder's
    ``frames``; none for the text archs."""
    from repro_torch.data import modality_inputs
    from repro_torch.rng import PRNGKey
    return modality_inputs(cfg, PRNGKey(seed, device), b)


def cache_layers(caches) -> list:
    """The per-layer cache dicts of a model's caches: an encoder-decoder's
    self caches, then its cross caches."""
    if isinstance(caches, dict):
        return list(caches["self"]) + list(caches["cross"])
    return list(caches)


def serve_gaps(params, cfg, toks, extra=None) -> dict:
    """``forward`` on toks (B, n + 1), ``prefill`` on the first n tokens and
    one ``decode_step`` on token n, each with the stub frontend inputs
    ``extra`` (a VLM's logits run P patch positions ahead of its tokens).
    Returns each call's kernel launches,
    whether its logits are finite, |forward|'s max (``scale``) and the
    max |diff| of prefill against forward at position n - 1 and of the
    decode step against forward at n: absolute (``prefill``, ``decode``) and
    relative to 1 + |forward| (``prefill_rel``, ``decode_rel``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import decode_step, forward, prefill
    n = toks.shape[1] - 1
    extra = extra or {}
    pt = patch_tokens(cfg)
    calls, finite = {}, {}
    with torch.inference_mode():
        kernels.reset_launch_counts()
        full, _ = forward(params, cfg, {"tokens": toks, **extra})
        full = full[:, pt:]
        torch.cuda.synchronize()
        calls["forward"] = kernels.launch_counts()
        kernels.reset_launch_counts()
        last, caches = prefill(params, cfg, {"tokens": toks[:, :n], **extra},
                               n + 8 + pt)
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
    out = {"launches": calls, "finite": finite, "prompt": n,
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
    twice; at head_dim 192 S^T twice, once a walk).  For information only: the bound counts live (q, k)
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
    # At head_dim 192 the dK/dV kernel walks twice, S^T once more.
    dkv_products = 7 if d > 128 else 6
    return b * h * (dq_tiles * 4 + dkv_tiles * dkv_products) * per


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
    # nemotron-4-340b's prefill shape, (4, 1024, 96/8, 192) causal.
    d192 = _attention_times(dev, SERVE_BATCH, SERVE_PROMPT, 96, 8, 192, True,
                            seed=121)
    mma = flash_mma_flops(SERVE_BATCH, SERVE_PROMPT, 96, 192)
    say(f"flash_attention at head_dim 192, the bf16 kernel's own tensor-core "
        f"work: {mma / 1e9:.1f} GFLOP, "
        f"{mma / (d192['ms'] * 1e-3) / 1e12:.0f} TFLOP/s achieved")
    # The float32 forward (tensor cores, split TF32) at F32_SHAPES.
    f32 = {name: f32_attention_times(dev, *shape, which="fwd")
           for name, shape in F32_SHAPES.items()}
    return {"flash_attention": fa, "ssd_scan": ssd, "flash_d192": d192,
            "ssd_jamba": _ssd_jamba_times(dev), "f32": f32}


def _ssd_jamba_times(dev) -> dict:
    """ssd_scan at jamba-v0.1-52b's prefill shape, (b, S, H, P, G, N) =
    (4, 1024, 128, 64, 1, 16), chunk 128: the kernel, its bound and the
    plain version."""
    from repro_torch.kernels.ssd_scan import ssd_apply, ssd_apply_ref
    b, s, h, p, g_, n, chunk = SERVE_BATCH, SERVE_PROMPT, 128, 64, 1, 16, 128
    args = _ssd_inputs(dev, b, s, h, p, g_, n, seed=122)
    out = {"ms": time_ms(lambda: ssd_apply(*args, chunk=chunk)),
           "plain": time_ms(lambda: ssd_apply_ref(*args), reps=1, trials=3),
           "lib": None}
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g_ * n
                  + b * h * p * n)
    ops = 2 * b * s * (g_ * chunk * n + h * p * (chunk + 2 * n))
    out["bound"], out["by"] = bound(nbytes, ops, TF32_OPS_PER_S)
    say(f"ssd_scan (b={b}, S={s}, H={h}, P={p}, G={g_}, N={n}, f32): kernel "
        f"{out['ms']:.4f} ms, bound {out['bound']:.4f} ms ({out['by']}: "
        f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; {ops / 1e9:.2f} GFLOP of the "
        f"chunked form at 495 TFLOP/s TF32 take "
        f"{ops / TF32_OPS_PER_S * 1e3:.4f} ms), plain {out['plain']:.4f} ms")
    return out


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
            "ssd_scan": 0, "ssd_scan_bwd": 0}
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
                "ssd_scan": 0, "ssd_scan_bwd": 0}
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
                    "ssd_scan": 0, "ssd_scan_bwd": 0}
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
            "ssd_scan_bwd": 0, **want}
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
                "ssd_scan": 0, "ssd_scan_bwd": 0}
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
# 3.44e-3 in bfloat16, the kernels' own gaps to the plain version then
# (float32 then on the CUDA cores) 4.4e-7 and 1.8e-3.
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
    # whisper-tiny's training shapes at full width: the encoder's 1500
    # frames non-causal (11 full 128-row tiles and a 92-row edge) and the
    # decoder's 448 tokens causal, batch 16.
    (16, 1500, 6, 6, 64, "bfloat16", False, 0),
    (16, 448, 6, 6, 64, "bfloat16", True, 0),
    # head_dim 96 (phi-3-vision-4.2b's training shape at full width, 32-column
    # slabs) and 192 (nemotron-4-340b's prefill shape: a 2-stage ring, dV
    # and dK in two walks), then each windowed and with S of no multiple of
    # 64, and not causal; the float32 pair at both.
    (4, 2048, 32, 32, 96, "bfloat16", True, 0),
    (4, 1024, 96, 8, 192, "bfloat16", True, 0),
    (1, 333, 8, 2, 96, "bfloat16", True, 40),
    (1, 333, 12, 2, 192, "bfloat16", True, 40),
    (1, 190, 6, 6, 96, "bfloat16", False, 0),
    (1, 257, 4, 2, 192, "bfloat16", False, 33),
    (2, 77, 8, 4, 96, "float32", True, 0),
    (1, 130, 4, 2, 96, "float32", False, 0),
    (2, 77, 6, 2, 192, "float32", True, 9),
    (1, 130, 4, 2, 192, "float32", False, 0),
    # The float32 kernels (tensor cores, split TF32) at every head_dim:
    # causal with a GQA group of 8, windowed with a group of 1, not causal
    # with a group of 3, each at an S of no multiple of their 16- to 64-row
    # tiles.
] + [(b, s, h, kv, d, "float32", causal, window)
     for d in (16, 32, 64, 96, 128, 192)
     for b, s, h, kv, causal, window in ((1, 133, 16, 2, True, 0),
                                         (2, 77, 4, 4, True, 20),
                                         (1, 100, 6, 2, False, 0))]
# (b)–(d): gradients on the card against the CPU (TF32 off) within GRAD_TOL
# of each leaf's largest magnitude, the limit that holds the port's
# gradients to the reference's (tests/test_torch_train.py).
GRAD_TOL = 1e-4
# (b): the SSD backward kernels (ssd_scan_bwd) against the plain backward
# (the vjp of the chunked form) in float32 and float64, each gradient's max
# |diff| over its max |value|.  The limit is twice the plain float32 vjp's
# own error against float64 on the first two shapes, as BWD_TOL (H100 80GB
# HBM3 at 700 W, PERF.md): at most 7.21e-6, the kernels' own error against
# float64 then at most 3.17e-6 on any shape of the list.
SSD_BWD_TOL = 1.5e-5
SSD_BWD_SHAPES = [      # (b, S, H, P, G, N, the plain form's chunk, decaying)
    (4, 1024, 64, 64, 1, 128, 128, False),      # mamba2-1.3b's
    (4, 1024, 128, 64, 1, 16, 128, False),      # jamba-v0.1-52b's
    # Three heads a group and a ragged tail (S of no multiple of the
    # kernels' 32-step chunk); P 4 and N 16; P 68 (two 64-row slabs) and
    # N 72 at S 16; S 1000.
    (2, 80, 6, 8, 2, 16, 16, False),
    (2, 64, 4, 4, 2, 16, 32, False),
    (1, 16, 3, 68, 1, 72, 16, False),
    (1, 1000, 4, 64, 1, 128, 8, False),
    # Phase 9's long, strongly decaying sequence.  The plain form is taken
    # at chunk 1 (the step recurrence): at 128 it takes each exponent as a
    # difference of running sums, which cancels in float32 (9.6e-3 of
    # float64 on such an input in tests/test_torch_attention_ssd.py).
    (1, 2048, 4, 64, 1, 128, 1, True),
]
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
    BWD_SHAPES, and its times at qwen3-14b's prefill shape and at head_dim
    96 and 192."""
    import torch
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     FlashAttentionBackward,
                                                     gqa_attention_bwd_ref)
    say("== 16a. flash_attention backward against the plain backward")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(16)
    worst_abs = worst_f32 = 0.0
    readings = {}
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
        gap = max((a.float() - c.float()).abs().max().item()
                  for a, c in zip(got, plain))
        worst_abs = max(worst_abs, gap)
        if dt == "float32":
            worst_f32 = max(worst_f32, gap)
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
    # Repeat calls of the float32 backward give the same bits (every output
    # element summed by one thread of one block, no atomics).
    for b, s, h, kv, d, causal, window in F32_REPEATS:
        q = torch.randn((b, s, h, d), generator=g, device=dev)
        k, v = (torch.randn((b, s, kv, d), generator=g, device=dev)
                for _ in range(2))
        do = torch.randn((b, s, h, d), generator=g, device=dev)
        o, lse = FlashAttention.apply(q, k, v, causal, window, True)
        first = FlashAttentionBackward.apply(q, k, v, o, lse, do, causal,
                                             window)
        for _ in range(2):
            again = FlashAttentionBackward.apply(q, k, v, o, lse, do, causal,
                                                 window)
            if not all(torch.equal(x, y) for x, y in zip(first, again)):
                raise AssertionError(f"float32 flash backward "
                                     f"{(b, s, h, kv, d)}: repeat calls "
                                     f"differ")
        say(f"float32 flash backward {(b, s, h, kv, d, causal, window)}: "
            f"three calls bit-identical")
        del q, k, v, do, o, lse, first, again
    t = _bwd_times(dev, g, SERVE_BATCH, SERVE_PROMPT, 40, 8, 128)
    t["err"], t["f32_err"] = worst_abs, worst_f32
    # The float32 backward (tensor cores, split TF32) at F32_SHAPES.
    t["f32"] = {name: f32_attention_times(dev, *shape, which="bwd")
                for name, shape in F32_SHAPES.items()}
    # phi-3-vision-4.2b's training shape and nemotron-4-340b's prefill
    # shape, the head_dims 96 and 192.
    t["d96"] = _bwd_times(dev, g, *BWD_D96)
    t["d192"] = _bwd_times(dev, g, *BWD_D192)
    return t


# (B, S, H, KV, D, causal, window) of phase 16a's repeat-call checks of
# the float32 backward: GQA groups of 5 and 8, a window, no causal mask.
F32_REPEATS = [(2, 333, 10, 2, 128, True, 0), (1, 300, 16, 2, 64, True, 40),
               (1, 257, 6, 6, 192, False, 0), (2, 130, 8, 1, 16, True, 0)]
# (B, S, H, KV, D) of phase 16a's timings at head_dim 96 and 192, causal.
BWD_D96 = (4, 2048, 32, 32, 96)
BWD_D192 = (4, 1024, 96, 8, 192)


def _bwd_times(dev, g, b, s, h, kvh, d) -> dict:
    """The bf16 backward kernels at (b, s, h/kvh, d) causal: their time
    beside the bound, the plain backward and SDPA's backward, then the
    float32 pair's time at the same shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     FlashAttentionBackward,
                                                     gqa_attention_bwd_ref)
    q = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((b, s, kvh, d), generator=g, device=dev).bfloat16()
            for _ in range(2))
    do = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
    o, lse = FlashAttention.apply(q, k, v, True, 0, True)
    t = {"shape": [b, s, h, kvh, d],
         "ms": time_ms(lambda: FlashAttentionBackward.apply(
             q, k, v, o, lse, do, True, 0), reps=5, trials=7),
         "plain": time_ms(lambda: gqa_attention_bwd_ref(q, k, v, o, do),
                          reps=2, trials=5)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=h != kvh)

    both = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                   reps=5, trials=7)
    fwd = time_ms(sdpa, reps=5, trials=7)
    t["lib"] = both - fwd
    nbytes = 2 * (4 * q.numel() + 4 * k.numel())   # q o do dq, k v dk dv
    ops = 10 * b * h * d * s * (s + 1) // 2   # 5 products of the live pairs
    t["bound"], t["by"] = bound(nbytes, ops, BF16_OPS_PER_S)
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
    del qt, kt, vt, dot
    q, k, v, do = (x.float() for x in (q, k, v, do))
    o, lse = FlashAttention.apply(q, k, v, True, 0, True)
    t["f32_ms"] = time_ms(lambda: FlashAttentionBackward.apply(
        q, k, v, o, lse, do, True, 0), reps=2, trials=5)
    say(f"flash_attention backward, the float32 kernels (tensor cores, "
        f"split TF32) at the same shape: {t['f32_ms']:.4f} ms")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return t


# The float32 attention kernels' timing shapes (B, S, H, KV, D), causal:
# qwen3-14b's prefill; the lm FL round at the paper's width (fl-lm-12m, 30
# clients x 32 sequences of 64 tokens in one launch); the registered micro
# lm's training launch in phase 16e (2 strategies x 3 clients x 4
# sequences of 16 tokens, head_dim 16; recorded by
# scripts/torch_flash_f32_bench.py).
F32_SHAPES = {"qwen3-14b": (4, 1024, 40, 8, 128),
              "lm round": (960, 64, 4, 2, 64),
              "micro lm": (24, 16, 4, 2, 16)}


def f32_attention_times(dev, b, s, h, kvh, d, which="fwd") -> dict:
    """The float32 attention kernels at (b, s, h/kvh, d) causal, forward
    (as a training step runs it: each row's logsumexp written too) or
    backward, first held to the plain version on the same inputs (the
    forward's output within FLASH_F32_TOL (1 + |o|); each gradient within
    BWD_TOL["float32"] of its max |grad| of a float64 backward, and of the
    plain float32 one beyond that one's own error), then timed: the kernel's time beside its bound (the
    products once at 495 TFLOP/s TF32, or the bytes each input read and
    each output written once, whichever is larger), the plain version's
    time and scaled_dot_product_attention's in float32 (``enable_gqa``; its
    backward as torch.autograd.grad of its forward less the forward).  With
    ``which="bwd"`` also the device time of each kernel the backward
    launches, by name (``kernel_times_us``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (FlashAttentionBackward,
                                                     gqa_attention_bwd_ref,
                                                     gqa_attention_ref)
    from repro_torch.kernels.flash_attention.flash_attention import launch
    old = _tf32(False, False)
    g = torch.Generator(device=dev).manual_seed(29)
    q = torch.randn((b, s, h, d), generator=g, device=dev)
    k, v = (torch.randn((b, s, kvh, d), generator=g, device=dev)
            for _ in range(2))
    do = torch.randn((b, s, h, d), generator=g, device=dev)
    o, lse = launch(q, k, v, causal=True, window=0, with_lse=True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=h != kvh)

    out = {"shape": [b, s, h, kvh, d]}
    stats = 4 * b * h * s                  # lse, written or read
    pairs = s * (s + 1) // 2
    if which == "fwd":
        def call():
            return launch(q, k, v, causal=True, window=0, with_lse=True)
        plain = (lambda: gqa_attention_ref(q, k, v, True, 0, with_lse=True))
        want = plain()[0]
        err = (o - want).abs()
        out["err"] = err.max().item()
        if bool((err > FLASH_F32_TOL * (1 + want.abs())).any()) or not bool(
                torch.isfinite(o).all()):
            raise AssertionError(f"float32 flash forward {tuple(out['shape'])}"
                                 f": max |diff| {out['err']} from the plain "
                                 f"version (limit {FLASH_F32_TOL} (1 + |o|))")
        del want, err
        nbytes = 4 * (2 * q.numel() + 2 * k.numel()) + stats
        ops = 4 * b * h * d * pairs
    else:
        def call():
            return FlashAttentionBackward.apply(q, k, v, o, lse, do, True, 0)
        plain = (lambda: gqa_attention_bwd_ref(q, k, v, o, do, True, 0))
        # Within BWD_TOL of float64, and of the plain float32 backward
        # beyond the plain's own error against float64 (which at S = 1024
        # exceeds BWD_TOL by itself).
        got, want = call(), plain()
        exact = gqa_attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                                      True, 0)
        out["err"] = max(_rel(a, e) for a, e in zip(got, exact))
        out["err_plain"] = max(_rel(a, c) for a, c in zip(got, want))
        out["plain_err"] = max(_rel(c, e) for c, e in zip(want, exact))
        del want, exact
        if not (out["err"] <= BWD_TOL["float32"] and out["err_plain"]
                <= BWD_TOL["float32"] + out["plain_err"]) or not all(
                    bool(torch.isfinite(x).all()) for x in got):
            raise AssertionError(
                f"float32 flash backward {tuple(out['shape'])}: "
                f"{out['err']} of max |grad| from float64 (limit "
                f"{BWD_TOL['float32']}), {out['err_plain']} from the plain "
                f"backward (limit {BWD_TOL['float32']} + its own "
                f"{out['plain_err']})")
        del got
        nbytes = 4 * (4 * q.numel() + 4 * k.numel()) + stats
        ops = 10 * b * h * d * pairs
    torch.cuda.empty_cache()
    lib_fwd = time_ms(sdpa, reps=5, trials=7)
    out["lib"] = lib_fwd if which == "fwd" else time_ms(
        lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), reps=5,
        trials=7) - lib_fwd
    out["ms"] = time_ms(call, reps=5, trials=7)
    out["plain"] = time_ms(plain, reps=2, trials=5)
    out["bound"], out["by"] = bound(nbytes, ops, TF32_OPS_PER_S)
    out["mb"], out["gflop"] = nbytes / 1e6, ops / 1e9
    out["kernels_us"] = kernel_times_us(call) if which == "bwd" else {}
    say(f"float32 flash {'forward' if which == 'fwd' else 'backward'} "
        f"{tuple(out['shape'])} causal: "
        + (f"max abs err {out['err']:.3e} from the plain version"
           if which == "fwd" else
           f"{out['err']:.2e} of max |grad| from float64, "
           f"{out['err_plain']:.2e} from the plain backward (the plain's own "
           f"{out['plain_err']:.2e})")
        + f"; kernel{'s' if which == 'bwd' else ''} {out['ms']:.4f} ms, bound {out['bound']:.4f} ms ({out['by']}: "
        f"{out['gflop']:.2f} GFLOP at 495 TFLOP/s TF32, {out['mb']:.1f} MB "
        f"at 3.35 TB/s; {out['bound'] / out['ms']:.1%} of it), plain "
        f"{out['plain']:.4f} ms, scaled_dot_product_attention float32 "
        f"{out['lib']:.4f} ms"
        + "".join(f"; {n} {t:.1f} us" for n, t in out["kernels_us"].items()))
    del q, k, v, do, o, lse, qt, kt, vt, dot
    torch.cuda.empty_cache()
    _tf32(*old)
    return out


def kernel_times_us(call) -> dict:
    """Device time of each kernel a ``call()`` launches, by its name without
    namespace, template arguments or parameters (torch.profiler): the
    median of its launches over ten calls, in microseconds."""
    import re
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            name = re.sub(r"^void |\(anonymous namespace\)::", "", ev.name)
            times.setdefault(re.split(r"[<(]", name)[0],
                             []).append(ev.device_time_total)
    return {k: statistics.median(v) for k, v in times.items()}


def f32_entry(name: str, which: str, readings: dict, launches: int,
              err: float) -> dict:
    """The final line's entry of a float32 attention kernel: its numbers at
    the lm round's shape (the float32 main path, phase 16e's paper-width
    run, whose launches it counts), then at the other F32_SHAPES."""
    main = readings["lm round"]
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/flash_attention"
                         ".py:82" + ("" if which == "fwd" else
                                     " (no TPU backward kernel: the "
                                     "reference differentiates XLA "
                                     "attention)"),
             "launches": launches, "max_abs_err": err, "shape": main["shape"],
             "ms": main["ms"], "plain_ms": main["plain"],
             "bound_ms": main["bound"], "bound_by": main["by"],
             "library_ms": main["lib"]}
    for key, prefix in (("qwen3-14b", "qwen"), ("micro lm", "micro")):
        r = readings[key]
        entry.update({f"{prefix}_shape": r["shape"], f"{prefix}_ms": r["ms"],
                      f"{prefix}_plain_ms": r["plain"],
                      f"{prefix}_bound_ms": r["bound"],
                      f"{prefix}_bound_by": r["by"],
                      f"{prefix}_library_ms": r["lib"]})
    if which == "bwd":
        entry["qwen_kernels_us"] = readings["qwen3-14b"]["kernels_us"]
    return entry


def _lm_grads(cfg, device, key, toks, targets, extra=None):
    """d(token_ce(forward)) of the flat params made from ``key`` on the
    CPU, computed on ``device`` -> CPU tensors; ``extra`` the stub frontend
    inputs (CPU tensors) of an encoder-decoder or a VLM."""
    import torch
    from repro_torch.models import forward, init_model, token_ce
    from repro_torch.models.transformer import (flatten_params,
                                                unflatten_params)
    flat = flatten_params(init_model(key, cfg, device="cpu"))
    batch = {"tokens": toks, **(extra or {})}

    def loss(p):
        logits, _ = forward(unflatten_params(p), cfg,
                            {k: v.to(device) for k, v in batch.items()})
        if cfg.arch_type == "vlm":          # its text, after the patches
            logits = logits[:, -targets.shape[1]:]
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
    from repro_torch.kernels.ssd_scan import backward as ssd_backward
    from repro_torch.kernels.ssd_scan import ssd_apply
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
    bwd = phase16b_ssd_backward(dev)

    say("== 16d. the repaired fault: model gradients, card against CPU")
    fault = {}
    for arch, leaves in (("qwen3-14b", ("attn.wq", "attn.wk", "attn.wv")),
                         ("mamba2-1.3b", ("mamba.in_proj",))):
        cfg = get_config(arch).reduced(dtype="float32")
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 200)))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        ssd_backward.vjp_calls = 0
        got = _lm_grads(cfg, dev, rng.PRNGKey(3), toks, _targets(toks))
        launches = {**kernels.launch_counts(),
                    "ssd_vjp": ssd_backward.vjp_calls}
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
        mamba = arch == "mamba2-1.3b"
        if launches["ssd_vjp"] or (mamba and launches["ssd_scan_bwd"]
                                   != cfg.num_layers):
            raise AssertionError(f"{arch}: the SSD backward on the card ran "
                                 f"{launches['ssd_scan_bwd']} kernel "
                                 f"launches and {launches['ssd_vjp']} plain "
                                 f"vjps; expected one launch a layer and no "
                                 f"vjp")
        fault[arch] = gap
    _tf32(*old)
    return {"ssd_grad_gap": gap, "ssd_bwd": bwd, "fault": fault}


def ssd_bwd_mma_flops(b: int, s: int, h: int, p: int, g_: int,
                      n: int) -> int:
    """Tensor-core operations the SSD backward kernels run
    (csrc/ssd_scan_bwd.cu), each product three times for the split TF32, N
    padded to 16/32/64/128: C.B^T once per 64-step chunk and group; per head,
    64-row slab of P and 32-step chunk the state walk's update and the
    gradient walk's G.B^T, gy^T.M and G's update; per head, 64-step chunk
    and 32 rows of P the head-summed pass's gy.X^T, gy.S_in and X.G; and per
    64-step chunk and group (sum_h dS_h).B and its C twin (counted once a
    group; each block of the group's cluster runs them on its own sum).  For
    information only: the bound counts the chunked form's products once."""
    np_ = next(w for w in (16, 32, 64, 128) if n <= w)
    c64, c32 = -(-s // 64), -(-s // 32)
    slabs, shares = -(-p // 64), -(-p // 32)
    prep = b * c64 * g_ * 64 * 64 * np_
    walks = b * h * slabs * c32 * 64 * (np_ * 32 + 32 * np_ + 32 * 32
                                        + np_ * 32)
    group = (b * h * c64 * shares * 64 * 32 * (64 + 2 * np_)
             + b * c64 * g_ * 2 * 64 * np_ * 64)
    return 3 * 2 * (prep + walks + group)


def _ssd_bwd_case(dev, b, s, h, p, g_, n, chunk, decaying, seed) -> dict:
    """ssd_scan_bwd at one shape against the plain vjp in float32 and
    float64; two calls bit-identical."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunked_ref
    from repro_torch.kernels.ssd_scan.backward import launch_backward
    x, dt, A, B, C = _ssd_inputs(dev, b, s, h, p, g_, n, seed=seed,
                                 decaying=decaying)
    args = [x, dt, A.expand(b, h).contiguous(), B, C]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    gy = torch.randn((b, s, h, p), generator=gen, device=dev)
    gf = torch.randn((b, h, p, n), generator=gen, device=dev)

    def plain(dtype):
        _, vjp = torch.func.vjp(lambda *a: ssd_chunked_ref(*a, chunk),
                                *(t.to(dtype) for t in args))
        return vjp((gy.to(dtype), gf.to(dtype)))

    got = launch_backward(*args, gy, gf)
    again = launch_backward(*args, gy, gf)
    p32, p64 = plain(torch.float32), plain(torch.float64)
    torch.cuda.synchronize()
    return {"k_vs_p": max(_rel(a, c) for a, c in zip(got, p32)),
            "k_vs_64": max(_rel(a, e) for a, e in zip(got, p64)),
            "p_vs_64": max(_rel(c, e) for c, e in zip(p32, p64)),
            "abs": max((a - c).abs().max().item() for a, c in zip(got, p32)),
            "same": all(torch.equal(a, c) for a, c in zip(got, again)),
            "finite": all(bool(torch.isfinite(a).all()) for a in got)}


def _ssd_bwd_times(dev, b, s, h, p, g_, n, chunk) -> dict:
    """ssd_scan_bwd at (b, s, h, p, g_, n): its time, its bound (bytes: x,
    gy, dt, A, B, C and gfin read and dx, ddt, dA, dB, dC written once;
    operations: the chunked form's backward products once at ``chunk``) and
    the plain vjp's time."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunked_ref
    from repro_torch.kernels.build import library
    from repro_torch.kernels.ssd_scan.backward import launch_backward
    from repro_torch.launch.roofline import ssd_bwd_flops
    x, dt, A, B, C = _ssd_inputs(dev, b, s, h, p, g_, n, seed=17)
    args = [x, dt, A.expand(b, h).contiguous(), B, C]
    gen = torch.Generator(device=dev).manual_seed(18)
    gy = torch.randn((b, s, h, p), generator=gen, device=dev)
    gf = torch.randn((b, h, p, n), generator=gen, device=dev)

    def plain():
        _, vjp = torch.func.vjp(lambda *a: ssd_chunked_ref(*a, chunk), *args)
        return vjp((gy, gf))

    out = {"shape": [b, s, h, p, g_, n],
           "ms": time_ms(lambda: launch_backward(*args, gy, gf)),
           "plain": time_ms(plain, reps=2, trials=5), "lib": None,
           "kernels_us": ssd_bwd_kernel_times(
               lambda: launch_backward(*args, gy, gf)),
           "scratch_mb": library().repro_ssd_scan_bwd_scratch_bytes(
               b, s, h, p, g_, n) / 1e6}
    nbytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 2 * b * h
                  + 4 * b * s * g_ * n + b * h * p * n)
    ops = ssd_bwd_flops((b, s, h, p), (b, s, g_, n), chunk)
    out["bound"], out["by"] = bound(nbytes, ops, TF32_OPS_PER_S)
    mma = ssd_bwd_mma_flops(b, s, h, p, g_, n)
    say(f"ssd_scan_bwd (b={b}, S={s}, H={h}, P={p}, G={g_}, N={n}, f32): "
        f"kernel {out['ms']:.4f} ms, bound {out['bound']:.4f} ms "
        f"({out['by']}: {nbytes / 1e6:.1f} MB at 3.35 TB/s take "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; the chunked form's "
        f"backward products at chunk {chunk}, {ops / 1e9:.2f} GFLOP, take "
        f"{ops / TF32_OPS_PER_S * 1e3:.4f} ms at 495 TFLOP/s TF32), plain "
        f"vjp {out['plain']:.4f} ms; no single PyTorch call computes it, so "
        f"no library time; the kernels' own tensor-core work {mma / 1e9:.1f} "
        f"GFLOP (split TF32), {mma / (out['ms'] * 1e-3) / 1e12:.0f} TFLOP/s "
        f"achieved; scratch {out['scratch_mb']:.1f} MB; by kernel (median "
        f"of ten calls) "
        + ", ".join(f"{k} {v:.1f} us" for k, v in out["kernels_us"].items()))
    out["mma_gflop"] = mma / 1e9
    return out


def ssd_bwd_kernel_times(call) -> dict:
    """Device time of each of ssd_scan_bwd's kernels (torch.profiler), the
    median of ten calls, in microseconds; the two walks apart."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA" and "ssd_bwd_" in ev.name:
            if "walk" in ev.name:
                key = "grad walk" if "true" in ev.name else "state walk"
            else:
                key = ev.name.split("ssd_bwd_")[1].split("_kernel")[0]
            times.setdefault(key, []).append(ev.device_time_total)
    if not times:
        raise AssertionError("the profiler saw no ssd_bwd kernel")
    return {k: statistics.median(v) for k, v in times.items()}


def phase16b_ssd_backward(dev) -> dict:
    """ssd_scan_bwd against the plain backward at SSD_BWD_SHAPES, then timed
    at mamba2-1.3b's and jamba-v0.1-52b's shapes."""
    import torch
    say("== 16b. ssd_scan_bwd against the plain vjp (float32 and float64)")
    worst_abs = 0.0
    for i, (b, s, h, p, g_, n, chunk, decaying) in enumerate(SSD_BWD_SHAPES):
        r = _ssd_bwd_case(dev, b, s, h, p, g_, n, chunk, decaying,
                          seed=160 + i)
        what = (b, s, h, p, g_, n, chunk, decaying)
        say(f"ssd_scan_bwd {what}: kernel vs plain {r['k_vs_p']:.2e}, plain "
            f"vs float64 {r['p_vs_64']:.2e}, kernel vs float64 "
            f"{r['k_vs_64']:.2e} (of max |grad|; limit {SSD_BWD_TOL:.1e}); "
            f"two calls bit-identical: {r['same']}")
        if not max(r["k_vs_p"], r["k_vs_64"]) <= SSD_BWD_TOL \
                or not r["same"] or not r["finite"]:
            raise AssertionError(f"ssd_scan_bwd {what}: {r}")
        worst_abs = max(worst_abs, r["abs"])
        torch.cuda.empty_cache()
    out = {"err": worst_abs,
           "mamba": _ssd_bwd_times(dev, SERVE_BATCH, SERVE_PROMPT, 64, 64,
                                   1, 128, 128),
           "jamba": _ssd_bwd_times(dev, SERVE_BATCH, SERVE_PROMPT, 128, 64,
                                   1, 16, 128)}
    torch.cuda.empty_cache()
    return out


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
    from repro_torch.kernels.ssd_scan import backward as ssd_backward
    from repro_torch.launch.train import run_train, synth_lm_batch
    for batch in (TRAIN_BATCH, TRAIN_BATCH // 2):
        gc.collect()                 # a failed attempt's tensors, if any
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        ssd_backward.vjp_calls = 0
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
        launches["ssd_vjp"] = ssd_backward.vjp_calls / TRAIN_STEPS
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
    from repro_torch.configs import get_config
    say(f"== 16f. run_train at full width, {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens (the configs' remat)")
    out = {}
    for arch, kw in (("mamba2-1.3b", {}),
                     ("qwen3-14b", {"num_layers": TRAIN_QWEN_LAYERS})):
        want = train_launches(dataclasses.replace(get_config(arch), **kw))
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
        if r["launches"]["ssd_vjp"] or any(r["launches"][k] != n
                                           for k, n in want.items()):
            raise AssertionError(f"{arch}: launches a step {r['launches']}; "
                                 f"expected {want} (the recompute's forward "
                                 f"launches included) and no plain vjp")
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
                                  "ssd_scan", "ssd_scan_bwd"))):
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


# Phase 18: the analysis layer (repro_torch.analysis) on the card.  (a) the
# CLI in a fresh interpreter; (b) the registry sweep in this one, with the
# kernels' ops in the traced graphs and the block gate's classifier timed
# per builtin strategy, cold and from its cache; (c) validate(deep=True) on
# phase 13b's paper grid and phase 16e's fl-lm-12m spec, then the seeded
# violations of tests/test_analysis.py (their torch counterparts) with the
# reference's codes; (d) a row-wise extension strategy registered with
# check=True through hier and async at the population engines' paper width
# (phase 15's: 10 blocks of 10, case1b, one seed, POP_ROUNDS rounds), hier
# and degenerate async held to sim at POP_PIN (TF32 off), hier's selections
# bit-equal to the same trial on the CPU; (e) a non-separable extension
# refused by hier before any launch, then vouched for and run.
EXT_ROWWISE, EXT_ALL, EXT_NONSEP = ("_smoke_rowwise", "_smoke_rowwise_all",
                                    "_smoke_nonsep")


def _smoke_fixtures():
    """The torch counterparts of tests/test_analysis.py's seeded
    violations: (kind, name, callable, the reference's code)."""
    import dataclasses as dc
    import torch
    from repro_torch import rng
    from repro_torch.core.selection import SelectionResult
    from repro_torch.fl import get_workload

    def bad_dtype(key, hists, n_select=None):
        scores = hists.sum(-1)
        return SelectionResult((scores > 0).to(torch.int32), scores,
                               torch.argsort(-scores).to(torch.float32),
                               n_select)

    def traced_bool(key, hists, n_select=None):
        scores = hists.sum(-1)
        if scores.sum() > 0:
            scores = scores / scores.sum()
        return SelectionResult((scores > 0).to(torch.float32), scores,
                               torch.argsort(-scores).to(torch.int32),
                               n_select)

    def traced_budget(key, hists, n_select=None):
        scores = hists.sum(-1)
        return SelectionResult((scores > 0).to(torch.float32), scores,
                               torch.argsort(-scores).to(torch.int32),
                               torch.tensor(n_select or 4))

    def const_seeded(key, hists, n_select=None):
        scores = rng.uniform(rng.PRNGKey(0, hists.device), (hists.shape[0],))
        return SelectionResult(torch.ones_like(scores), scores,
                               torch.argsort(-scores).to(torch.int32),
                               n_select)

    cnn = get_workload("cnn")

    def no_hists(ds, plan_t, key):
        out = dict(cnn.materialize(ds, plan_t, key))
        out.pop("hists")
        return out

    def callback_metric(state):
        return torch.as_tensor(state["hists"].cpu().numpy().sum())

    def bool_metric(state):
        if state["hists"].sum() > 0:
            return state["hists"].sum()
        return torch.tensor(0.0)

    return [("strategy", "_smoke_bad_dtype", bad_dtype, "A003"),
            ("strategy", "_smoke_traced_bool", traced_bool, "A001"),
            ("strategy", "_smoke_traced_budget", traced_budget, "A004"),
            ("strategy", "_smoke_const_seed", const_seeded, "A006"),
            ("workload", "_smoke_no_hists",
             dc.replace(cnn, materialize=no_hists), "A101"),
            ("metric", "_smoke_cb_metric", callback_metric, "A005"),
            ("metric", "_smoke_bool_metric", bool_metric, "A301"),
            ("metric", "_smoke_big_metric",
             lambda state: state["hists"].new_zeros((128, 64)), "A302")]


def _unregister(name: str) -> None:
    """Take a strategy this phase registered out of the registry."""
    from repro_torch.core import selection as tsel
    tsel.STRATEGIES.pop(name, None)
    if name in tsel._REGISTRY_ORDER:
        tsel._REGISTRY_ORDER.remove(name)


def _smoke_nonsep(key, hists, n_select):
    """Row scores over a population-wide total: not block-separable."""
    from repro_torch.core.selection import SelectionResult, topn_mask
    scores = hists.sum(-1) / (hists.sum() + 1.0)
    mask, order = topn_mask(scores, scores > 0, n_select)
    return SelectionResult(mask, scores, order, n_select)


def _smoke_rowwise(key, hists, n_select):
    """A row-wise extension: labelwise's scores through a closure."""
    from repro_torch.core.selection import select_labelwise
    return select_labelwise(key, hists, n_select)


def _smoke_rowwise_all(key, hists, n_select):
    """A row-wise extension that selects every client with data (what the
    degenerate async ≡ sim identity needs), in σ²/n order."""
    from repro_torch.core.label_stats import label_variance_normed
    from repro_torch.core.ordered import class_sum
    from repro_torch.core.selection import SelectionResult, topn_mask
    scores = label_variance_normed(hists)
    n = hists.shape[-2]
    mask, order = topn_mask(scores, class_sum(hists) > 0, n)
    return SelectionResult(mask, scores, order, n)


def phase18a_cli(dev, card: str) -> dict:
    import os
    say(f"== 18a. python -m repro_torch.analysis --json --device {dev.type} "
        "(fresh interpreter)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json", "--device",
         dev.type], capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"analysis CLI exited {proc.returncode}:\n"
                             + proc.stdout[-4000:] + proc.stderr[-4000:])
    out = json.loads(proc.stdout)
    by_code: dict = {}
    for rec in out["findings"]:
        key = f"{rec['code']}/{rec['severity']}"
        by_code[key] = by_code.get(key, 0) + 1
    say(f"exit 0; findings by code {dict(sorted(by_code.items()))}; "
        f"{out['errors']} errors; wall {wall:.2f} s ({card})")
    return {"by_code": by_code, "wall_s": wall}


def phase18b_registries(dev, card: str) -> dict:
    import torch
    from repro_torch import rng
    from repro_torch.analysis import check_registries
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.analysis.separability import graph_ops, trace_graph
    from repro_torch.core.selection import BUILTIN_STRATEGIES
    from repro_torch.fl import get_workload
    from repro_torch.fl import population as pop
    say(f"== 18b. check_registries(device='{dev.type}'); the kernels' ops in "
        "the traced graphs; the block gate's classifier per builtin "
        "strategy")
    t0 = time.perf_counter()
    findings = check_registries(device=dev)
    wall = time.perf_counter() - t0
    if findings.errors():
        raise AssertionError("check_registries on the card:\n"
                             + "\n".join(d.render()
                                         for d in findings.errors()))
    verdicts = {d.name: d.detail for d in findings.by_code("A007")}
    say(f"no errors, {len(findings)} findings in {wall:.2f} s ({card}); "
        f"A007: " + ", ".join(f"{n}={'sep' if v['separable'] else 'NOT'}/"
                              f"{v['scores_dep']}"
                              for n, v in verdicts.items()))
    cnn, lm = get_workload("cnn"), get_workload("lm")
    ds = cnn.make_dataset(dev)
    plan = torch.zeros((8, 6), dtype=torch.int32, device=dev)
    key = torch.zeros(2, dtype=torch.int64, device=dev)
    mat_ops = graph_ops(trace_graph(lambda p, k: cnn.materialize(ds, p, k),
                                    plan, key)[0])
    lds = lm.make_dataset(dev)
    params = lm.init(rng.PRNGKey(0, dev), lds)
    batch = {"tokens": torch.zeros((6, 16), dtype=torch.int64, device=dev),
             "labels": torch.zeros(6, dtype=torch.int32, device=dev),
             "valid": torch.ones(6, dtype=torch.bool, device=dev)}
    # The attention Function's vmap rule keeps it out of a functionalised
    # trace: the loss's graph is make_fx's own.
    loss_ops = graph_ops(make_fx(lm.make_loss(lds), tracing_mode="fake",
                                 _allow_non_fake_inputs=True)(params, batch))
    if mat_ops.get("repro_torch.label_hist.default") != 1 or \
            not loss_ops.get("repro_torch.flash_attention.default"):
        raise AssertionError(f"kernel ops missing: materialize "
                             f"{mat_ops}, lm loss {loss_ops}")
    say(f"cnn materialize graph: {sum(mat_ops.values())} nodes, "
        f"label_hist x{mat_ops['repro_torch.label_hist.default']}; lm loss "
        f"graph: {sum(loss_ops.values())} nodes, flash_attention "
        f"x{loss_ops['repro_torch.flash_attention.default']}")
    times = {}
    for name in BUILTIN_STRATEGIES + ("labelwise_priority",
                                      "dirichlet_uniformity"):
        for k in [k for k in pop._SEPARABILITY_CACHE if k[0] == name]:
            del pop._SEPARABILITY_CACHE[k]
        t0 = time.perf_counter()
        v = pop._block_separability(name, 10, dev)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        pop._block_separability(name, 10, dev)
        cached = time.perf_counter() - t0
        times[name] = {"cold_s": cold, "cached_s": cached,
                       "separable": v.separable, "scores": v.scores_dep,
                       "mask_probe": v.mask_consistent}
    if [n for n, t in times.items() if not t["separable"]] != [
            "labelwise_priority"]:
        raise AssertionError(f"classifier verdicts: {times}")
    say(f"classifier at (32, 10) on {dev.type}, cold ms / cached µs "
        f"({card}): " + "; ".join(
            f"{n} {t['cold_s'] * 1e3:.1f} / {t['cached_s'] * 1e6:.1f} "
            f"({t['scores']})" for n, t in times.items()))
    return {"wall_s": wall, "classifier": times}


def phase18c_validate(dev, card: str) -> dict:
    import numpy as np
    from repro_torch.analysis import ContractError, check_metric
    from repro_torch.core import selection as tsel
    from repro_torch.fl import ScenarioSpec
    from repro_torch.fl import workloads as twl
    from repro_torch.obs import register_metric
    from repro_torch.obs import registry as treg
    say(f"== 18c. validate(deep=True, device='{dev.type}'): phase 13b's grid "
        "spec, phase 16e's fl-lm-12m spec, then the seeded violations")
    out = {}
    for what, spec in (("paper grid", _grid_spec()),
                       ("fl-lm-12m", _lm_fl_spec(np, "sim", LM_ROUNDS))):
        t0 = time.perf_counter()
        spec.validate(deep=True, device=dev)
        out[what] = time.perf_counter() - t0
        say(f"{what}: passes deep validation in {out[what]:.2f} s ({card})")
    micro = dict(scenarios=(ScenarioSpec.from_case("iid"),),
                 strategies=("labelwise",))
    base = _pop_spec("sim", **micro)
    got = {}
    for kind, name, obj, code in _smoke_fixtures():
        if kind == "strategy":
            tsel.register_strategy(name, obj, overwrite=True)
            spec = dataclasses.replace(base, strategies=(name,))
        elif kind == "workload":
            twl.register_workload(name, obj, overwrite=True)
            spec = dataclasses.replace(base, workload=name)
        else:
            register_metric(name, obj, requires=("hists",), overwrite=True,
                            axes=("a", "b") if code == "A302" else ())
            spec = dataclasses.replace(base, telemetry=(name,))
        try:
            if code == "A302":
                codes = {d.code for d in check_metric(name,
                                                      device=dev).errors()}
            else:
                try:
                    spec.validate(deep=True, device=dev)
                    codes = set()
                except ContractError as e:
                    codes = {d.code for d in e.findings.errors()}
        finally:
            _unregister(name)
            twl._WORKLOADS.pop(name, None)
            treg._METRICS.pop(name, None)
            if name in treg._METRIC_IDS:
                treg._METRIC_IDS.remove(name)
        if codes != {code}:
            raise AssertionError(f"{kind} {name}: codes {codes}, the "
                                 f"reference's {code}")
        got[name] = code
    say("seeded violations, each with the reference's code: "
        + ", ".join(f"{n} {c}" for n, c in got.items()))
    return {"validate_s": out, "codes": got}


def phase18d_extension(dev, card: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.selection import register_strategy
    from repro_torch.data import ImageDataset
    from repro_torch.fl import (ScenarioSpec, availability,
                                make_hier_trial_fn)
    say(f"== 18d. row-wise extension strategies registered with check=True "
        f"({EXT_ROWWISE}, {EXT_ALL}) through hier and async, paper width, "
        f"{POP_ROUNDS} rounds")
    for name, fn in ((EXT_ROWWISE, _smoke_rowwise),
                     (EXT_ALL, _smoke_rowwise_all)):
        t0 = time.perf_counter()
        register_strategy(name, fn, overwrite=True, check=True, device=dev)
        say(f"{name}: check=True passed in {time.perf_counter() - t0:.2f} s "
            f"({card})")
    ds = ImageDataset(device=dev)
    spec_h = _pop_spec("hier", strategies=(EXT_ROWWISE,))
    spec_a = _pop_spec("async", strategies=(EXT_ROWWISE,),
                       scenarios=(ScenarioSpec.from_case(
                           "case1b", transforms=(availability(0.3),)),),
                       engine_options=POP_ASYNC)
    old = _tf32(True, False)
    try:
        hier = _pop_run(dev, ds, spec_h, {"label_hist": POP_ROUNDS,
                                          "weighted_agg": 0})
        asy = _pop_run(dev, ds, spec_a, {"label_hist": POP_ROUNDS,
                                         "weighted_agg": POP_ROUNDS})
    finally:
        _tf32(*old)
    say(f"hier: launches {hier['launches']}, run {hier['wall_s']:.3f} s; "
        f"async: launches {asy['launches']}, run {asy['wall_s']:.3f} s "
        f"({card})")
    from repro_torch.fl import GridRun
    old = _tf32(False, False)
    try:
        plan = spec_h.scenarios[0].lower(spec_h.fl, (0,), POP_ROUNDS).plan
        card_h = make_hier_trial_fn(spec_h.fl, ds, strategy=EXT_ROWWISE,
                                    rounds=POP_ROUNDS)(plan, 0)
        grid = GridRun(plan[None], spec_h.fl, strategies=(EXT_ROWWISE,),
                       seeds=(0,), rounds=POP_ROUNDS, ds=ds, device=dev)
        for t in range(POP_ROUNDS):
            sel = grid.round(t)
            if not (np.array_equal(card_h["selected"][t],
                                   sel["selected"][0].cpu().numpy())
                    and np.array_equal(card_h["live"][t],
                                       sel["live"][0].cpu().numpy())):
                raise AssertionError(f"{EXT_ROWWISE} hier round {t}: "
                                     f"selection differs from sim's")
        gap_h = _pop_pin(f"{EXT_ROWWISE} hier vs sim", card_h,
                         grid.result(0.0))
        deg = _pop_run(dev, ds, _pop_spec(
            "async", strategies=(EXT_ALL,),
            engine_options={"buffer_k": 10, "tau_max": 0}),
            {"label_hist": POP_ROUNDS, "weighted_agg": POP_ROUNDS})
        sim = _pop_run(dev, ds, _pop_spec("sim", strategies=(EXT_ALL,)),
                       {"label_hist": POP_ROUNDS,
                        "weighted_agg": POP_ROUNDS})
        gap_a = _pop_pin(f"{EXT_ALL} degenerate async vs sim", deg["res"],
                         sim["res"])
    finally:
        _tf32(*old)
    cpu_h = make_hier_trial_fn(spec_h.fl, ImageDataset(device="cpu"),
                               strategy=EXT_ROWWISE, rounds=POP_ROUNDS,
                               device="cpu")(plan, 0)
    if not (np.array_equal(cpu_h["selected"], card_h["selected"])
            and np.array_equal(cpu_h["live"], card_h["live"])):
        raise AssertionError(f"{EXT_ROWWISE} hier: selections differ between "
                             "the card and the CPU")
    say(f"{EXT_ROWWISE}: hier selections bit-equal to sim's and to the CPU's "
        f"in each round; hier {gap_h:.3e} from sim; {EXT_ALL} degenerate "
        f"async {gap_a:.3e} from sim (limit {POP_PIN})")
    for name in (EXT_ROWWISE, EXT_ALL):
        _unregister(name)
    return {"hier": hier["launches"], "async": asy["launches"],
            "hier_sim_gap": gap_h, "async_sim_gap": gap_a}


def phase18e_refusal(dev, card: str) -> dict:
    import torch
    from repro_torch import kernels
    from repro_torch.core.selection import register_strategy
    from repro_torch.data import ImageDataset
    from repro_torch.fl import population as pop
    from repro_torch.fl import run
    say(f"== 18e. a non-separable extension ({EXT_NONSEP}) on hier: refused "
        "before any launch, then vouched for and run")
    register_strategy(EXT_NONSEP, _smoke_nonsep, overwrite=True, check=True,
                      device=dev)
    ds = ImageDataset(device=dev)
    spec = _pop_spec("hier", strategies=(EXT_NONSEP,))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        run(spec, ds=ds, device=dev)
        raise AssertionError(f"hier ran {EXT_NONSEP}")
    except ValueError as e:
        if "not block-separable" not in str(e):
            raise
        why = str(e)
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"launches before the refusal: "
                             f"{kernels.launch_counts()}")
    say(f"refused, no launch: {why[:160]}")
    pop.ASSUME_BLOCK_SEPARABLE.add(EXT_NONSEP)
    try:
        ran = _pop_run(dev, ds, spec, {"label_hist": POP_ROUNDS,
                                       "weighted_agg": 0})
    finally:
        pop.ASSUME_BLOCK_SEPARABLE.discard(EXT_NONSEP)
        _unregister(EXT_NONSEP)
    say(f"vouched for: ran with launches {ran['launches']} in "
        f"{ran['wall_s']:.3f} s ({card})")
    return {"launches": ran["launches"]}


# Phase 19: the launch tooling (ckpt/, data/specs.py, launch/steps.py,
# launch/dryrun.py, launch/roofline.py).  The dry-run traces over fake
# tensors on the host's CPU, about two minutes in all (mamba2-1.3b's train
# step at 16f's shape most of it), so a background process (one torch
# thread, niced) starts before the build and runs beside phases 2-18: it
# traces the six assigned prefill and decode pairs, then the steps phase 19
# runs on the card at phase 11's and 16f's shapes, then phase 21e's pairs
# of the VLM and audio archs, then phase 21f's phi-3-vision-4.2b train
# steps (batch 4, 2, 1 until one fits), and prints one JSON record a line
# to DRYRUN_LOG; phases 19 and 21e-f read them.
DRYRUN_LOG = ROOT / "build" / "phase19_dryrun.log"
DRYRUN_WAIT_S = 450            # the most phase 19 waits for the traces
P19_STEP_REPS = 3              # warm calls of a step timed (median)
P19_CKPT_DIR = ROOT / "build" / "phase19_ckpt"
DRYRUN_SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun

batch, prompt, seq, qwen_layers = map(int, sys.argv[1:])
torch.set_num_threads(1)


def emit(what, record):
    print(json.dumps({"what": what, **record}), flush=True)


def pair(arch, shape):
    emit(f"{arch} {shape}", dryrun.dryrun_one(arch, shape, save=False,
                                              verbose=False))


for arch in ("mamba2-1.3b", "qwen3-14b"):
    for shape in ("long_500k", "decode_32k", "prefill_32k"):
        pair(arch, shape)
meta = torch.device("meta")
for arch in ("qwen3-14b", "mamba2-1.3b"):
    cfg = get_config(arch)
    shape = InputShape("phase19_prefill", prompt + 1, batch, "prefill")
    params = dryrun.build_step(cfg, shape)[1][0]
    toks = torch.empty((batch, prompt), dtype=torch.int32, device=meta)
    emit(f"{arch} prefill step", dryrun.dryrun_step(
        arch, cfg, shape, args=(params, {"tokens": toks})))
for arch, layers in (("qwen3-14b", qwen_layers), ("mamba2-1.3b", 0)):
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    emit(f"{arch} train step", dryrun.dryrun_step(
        arch, cfg, InputShape("phase19_train", seq, batch, "train"),
        microbatches=1))
for arch in ("phi-3-vision-4.2b", "whisper-tiny"):          # phase 21e
    for shape in ("long_500k", "decode_32k", "prefill_32k"):
        pair(arch, shape)
cfg = get_config("phi-3-vision-4.2b")                        # phase 21f
for b in (4, 2, 1):
    rec = dryrun.dryrun_step("phi-3-vision-4.2b", cfg, InputShape(
        "phase21_train", cfg.num_patch_tokens + prompt, b, "train"),
        microbatches=1)
    emit(f"phi-3-vision-4.2b train b{b}", rec)
    if rec["fits_one_card"]:
        break
emit("phi-3-vision-4.2b train", {})
"""
_BACKGROUND: list = []


def start_dryrun() -> None:
    """Start the background dry-run process (see DRYRUN_SCRIPT);
    ``stop_background`` ends it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    DRYRUN_LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(DRYRUN_LOG, "w") as out:
        _BACKGROUND.append(subprocess.Popen(
            [sys.executable, "-c", DRYRUN_SCRIPT, str(SERVE_BATCH),
             str(SERVE_PROMPT), str(TRAIN_SEQ), str(TRAIN_QWEN_LAYERS)],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(10)))


def stop_background() -> None:
    for proc in _BACKGROUND:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def dryrun_records(wait_for) -> dict:
    """The background records by ``what``, once every ``what`` in
    ``wait_for`` is there (or the process has failed, or DRYRUN_WAIT_S has
    passed since the call)."""
    t0 = time.time()
    while True:
        records = {}
        for line in DRYRUN_LOG.read_text().splitlines():
            if line.startswith('{"what"'):
                r = json.loads(line)
                records[r["what"]] = r
        missing = set(wait_for) - set(records)
        if not missing:
            return records
        failed = any(p.poll() not in (None, 0) for p in _BACKGROUND)
        if failed or time.time() - t0 > DRYRUN_WAIT_S:
            raise AssertionError(f"dry-run records missing: {sorted(missing)}"
                                 f" (process failed: {failed}, waited "
                                 f"{time.time() - t0:.0f} s)\n"
                                 f"{DRYRUN_LOG.read_text()[-3000:]}")
        time.sleep(2)


def _warm_ms(dev, fn, reps: int = P19_STEP_REPS):
    """(median wall ms of ``reps`` warm ``fn()`` calls, each synchronised,
    peak bytes ``max_memory_allocated`` over one of them, the last result)."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), torch.cuda.max_memory_allocated(dev), out


def phase19a_checkpoints(dev, params, cfg) -> dict:
    """Full-width params saved from the card and loaded back onto it,
    bit-equal; then run_train with a checkpoint directory."""
    import shutil
    import torch
    from repro_torch.ckpt import latest_checkpoint, load_checkpoint, save_checkpoint
    from repro_torch.launch.steps import abstract_params
    from repro_torch.launch.train import run_train
    from repro_torch.models.transformer import flatten_params
    say(f"== 19a. checkpoints: {cfg.name} at full width ({cfg.dtype}) saved "
        f"from the card and loaded back onto it; run_train with ckpt_dir")
    shutil.rmtree(P19_CKPT_DIR, ignore_errors=True)
    flat = flatten_params(params)
    nbytes = sum(p.numel() * p.element_size() for p in flat.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(str(P19_CKPT_DIR), 7, params, {"arch": cfg.name})
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, meta = load_checkpoint(path, abstract_params(cfg), device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    back = flatten_params(back)
    if list(back) != list(flat) or meta != {"step": 7,
                                            "extra": {"arch": cfg.name}}:
        raise AssertionError(f"checkpoint: leaves or sidecar differ ({meta})")
    for k, p in flat.items():
        if back[k].device != p.device or not torch.equal(back[k], p):
            raise AssertionError(f"checkpoint leaf {k} differs after the "
                                 f"round trip")
    file_gb = Path(path).stat().st_size / 1e9
    say(f"{cfg.name}: {len(flat)} leaves, {nbytes / 1e9:.3f} GB of params, "
        f"file {file_gb:.3f} GB; save {t_save:.2f} s "
        f"({nbytes / 1e9 / t_save:.2f} GB/s), load onto the card "
        f"{t_load:.2f} s ({nbytes / 1e9 / t_load:.2f} GB/s); every leaf "
        f"bit-equal")
    del back
    shutil.rmtree(P19_CKPT_DIR)
    losses = run_train("mamba2-1.3b", steps=2, batch=2, seq=64, reduced=True,
                       ckpt_dir=str(P19_CKPT_DIR), log_every=10, device=dev)
    path = latest_checkpoint(str(P19_CKPT_DIR))
    meta = json.loads(Path(path.replace(".npz", ".json")).read_text())
    want = {"step": 2, "extra": {"arch": "mamba2-1.3b", "loss": losses[-1]}}
    if meta != want:
        raise AssertionError(f"run_train's checkpoint sidecar {meta}, "
                             f"expected {want}")
    say(f"run_train(mamba2-1.3b, reduced, 2 steps, ckpt_dir) on the card: "
        f"{Path(path).name} with extra {meta['extra']}")
    shutil.rmtree(P19_CKPT_DIR)
    return {"gb": nbytes / 1e9, "save_s": t_save, "load_s": t_load}


def phase19b_steps(dev, params, cfg, kernel: str) -> dict:
    """make_prefill_step / make_serve_step at phase 11's batch x prompt:
    tokens bit-equal to prefill's / decode_step's argmax on the same
    weights, one ``kernel`` launch a layer in the prefill step and none in
    the serve step; the prefill step timed warm with its peak memory."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import decode_step, prefill
    b, s = SERVE_BATCH, SERVE_PROMPT
    say(f"== 19b. {cfg.name}: make_prefill_step / make_serve_step at "
        f"{b} x {s} ({cfg.dtype}, a cache of {s + 1})")
    pre, _ = make_prefill_step(cfg, InputShape("phase19", s + 1, b,
                                               "prefill"))
    serve, _ = make_serve_step(cfg, InputShape("phase19", s + 1, b,
                                               "decode"))
    toks = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)
    batch = {"tokens": toks}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tok1, caches = pre(params, batch)
    torch.cuda.synchronize()
    pre_launches = kernels.launch_counts()
    with torch.no_grad():
        logits, ref_caches = prefill(params, cfg, batch, max_len=s + 1)
        want1 = torch.argmax(logits, dim=-1).to(torch.int32)
    if tok1.dtype != torch.int32 or not torch.equal(tok1, want1):
        raise AssertionError(f"{cfg.name}: prefill step tokens differ from "
                             f"prefill's argmax")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tok2, caches = serve(params, tok1, caches)
    torch.cuda.synchronize()
    serve_launches = kernels.launch_counts()
    with torch.no_grad():
        logits, _ = decode_step(params, cfg, tok1, ref_caches)
        want2 = torch.argmax(logits, dim=-1).to(torch.int32)
    if not torch.equal(tok2, want2):
        raise AssertionError(f"{cfg.name}: serve step tokens differ from "
                             f"decode_step's argmax")
    want = dict.fromkeys(pre_launches, 0)
    if serve_launches != want:
        raise AssertionError(f"{cfg.name}: serve step launches "
                             f"{serve_launches}")
    want[kernel] = cfg.num_layers
    if pre_launches != want:
        raise AssertionError(f"{cfg.name}: prefill step launches "
                             f"{pre_launches}, expected {want}")
    del caches, ref_caches, logits
    ms, peak, out = _warm_ms(dev, lambda: pre(params, batch))
    del out
    torch.cuda.empty_cache()
    say(f"{cfg.name}: prefill step tokens {tok1.tolist()} bit-equal "
        f"to prefill's argmax, serve step {tok2.tolist()} bit-equal to "
        f"decode_step's; launches: prefill step {pre_launches[kernel]} "
        f"{kernel}, serve step none; prefill step {ms:.1f} ms warm (median "
        f"of {P19_STEP_REPS}), peak {peak / 1e9:.2f} GB")
    return {"ms": ms, "peak": peak, "launches": pre_launches}


def phase19d_assigned(dev, params, arch: str, records: dict) -> dict:
    """One warm step of every assigned pair of ``arch`` that the dry-run
    marks fits_one_card: wall, peak and the estimate."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import (config_for_shape, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models import init_caches
    out = {}
    for name, shape in SHAPES.items():
        if shape.kind == "train":          # phase 19c reads those records
            continue
        rec = records[f"{arch} {name}"]
        if not rec["fits_one_card"]:
            continue
        cfg = config_for_shape(get_config(arch), shape)
        b, s = shape.global_batch, shape.seq_len
        g = np.random.default_rng(19)
        if shape.kind == "decode":
            step, _ = make_serve_step(cfg, shape)
            caches = init_caches(cfg, b, s, dev)
            for c in caches:
                c["idx"] = s - 1           # the step reads a full cache
            toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (b,))
                                    .astype(np.int32)).to(dev)
            fn = lambda: step(params, toks, caches)       # noqa: E731
        else:
            step, _ = make_prefill_step(cfg, shape)
            toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (b, s))
                                    .astype(np.int32)).to(dev)
            fn = lambda: step(params, {"tokens": toks})   # noqa: E731
        try:
            ms, peak, res = _warm_ms(dev, fn, reps=1)
        except torch.cuda.OutOfMemoryError as e:
            raise AssertionError(f"{arch} {name}: the dry-run marks it as "
                                 f"fitting one card, and it ran out of "
                                 f"memory: {e}") from e
        del res, fn
        torch.cuda.empty_cache()
        est = rec["peak_memory_per_device"]
        bound = max(rec["t_memory_s"], rec["t_compute_s"])
        say(f"{arch} {name} ({shape.kind}, batch {b}, seq {s}"
            f"{', window %d' % cfg.sliding_window if cfg.sliding_window else ''}"
            f"): one warm step {ms:.2f} ms, peak {peak / 1e9:.2f} GB "
            f"(max_memory_allocated), dry-run estimate {est / 1e9:.2f} GB "
            f"({peak / est - 1:+.1%}); dry-run t_memory (least bytes "
            f"{rec['bytes_per_device'] / 1e9:.2f} GB) "
            f"{rec['t_memory_s'] * 1e3:.2f} ms, t_compute "
            f"{rec['t_compute_s'] * 1e3:.3f} ms: the step at "
            f"{ms * 1e-3 / bound:.1f}x its bound; the eager program's "
            f"traffic {rec['eager_bytes_per_device'] / 1e9:.1f} GB")
        out[name] = {"ms": ms, "peak": peak, "estimate": est,
                     "bound_ms": bound * 1e3}
    return out


def _say_dryrun_vs_card(what: str, rec: dict, ms: float, peak: float,
                        card: str, extra: str = "") -> dict:
    # The MFU share counts the model's FLOPs (2/6·N·D); the traced FLOPs
    # also hold a rematerialised step's recompute.
    tflops = rec["model_flops"] / (ms * 1e-3) / 1e12
    traced = rec["flops_per_device"] / (ms * 1e-3) / 1e12
    gap = peak / rec["peak_memory_per_device"] - 1
    say(f"{what}: model 2/6·N·D {rec['model_flops'] / 1e12:.2f} TFLOP over "
        f"{ms:.1f} ms measured = {tflops:.1f} TFLOP/s, {tflops / 989:.1%} of "
        f"989 TFLOP/s bf16 (MFU); traced {rec['flops_per_device'] / 1e12:.2f}"
        f" TFLOP = {traced:.1f} TFLOP/s (useful_flops_fraction "
        f"{rec['useful_flops_fraction']:.3f}; kernel ops "
        f"{ {k: v for k, v in rec['kernel_launches'].items() if v} }, their "
        f"FLOPs "
        f"{ {k: round(v / 1e9, 1) for k, v in rec['kernel_flops'].items()} } "
        f"GFLOP){extra}; peak: dry-run estimate "
        f"{rec['peak_memory_per_device'] / 1e9:.2f} GB, measured "
        f"{peak / 1e9:.2f} GB ({gap:+.1%}); traced in {rec['trace_s']:.1f} s "
        f"({rec['nodes']} nodes, fake {rec['trace_device']}) ({card})")
    return {"tflops": tflops, "share": tflops / 989, "traced_tflops": traced,
            "peak_gap": gap}


def phase19(dev, card: str, p16f: dict) -> dict:
    """The launch tooling on the card: (a) checkpoints, (b) the prefill and
    serve steps at full width, (c) the dry-run against the card, (d) the
    assigned shapes that the dry-run says fit one card."""
    import gc
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import init_model
    from repro_torch.rng import PRNGKey
    arch_shapes = {f"{a} {s}" for a in ("qwen3-14b", "mamba2-1.3b")
                   for s in SHAPES if s != "train_4k"}
    out = {"steps": {}, "assigned": {}}
    for arch, kernel in (("mamba2-1.3b", "ssd_scan"),
                         ("qwen3-14b", "flash_attention")):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = init_model(PRNGKey(0, dev), cfg, device=dev)
        torch.cuda.synchronize()
        say(f"== 19. {arch}: full-width weights drawn in "
            f"{time.perf_counter() - t0:.1f} s")
        if arch == "mamba2-1.3b":
            out["ckpt"] = phase19a_checkpoints(dev, params, cfg)
        out["steps"][arch] = phase19b_steps(dev, params, cfg, kernel)
        records = dryrun_records(arch_shapes)
        fits = [s for s in SHAPES if s != "train_4k"
                and records[f"{arch} {s}"]["fits_one_card"]]
        say(f"== 19d. {arch}: the assigned prefill and decode pairs the "
            f"dry-run marks fits_one_card: {fits}")
        out["assigned"][arch] = phase19d_assigned(dev, params, arch, records)
        del params
        gc.collect()
        torch.cuda.empty_cache()

    say("== 19c. the dry-run against the card")
    whats = {f"{a} {k}" for a in ("qwen3-14b", "mamba2-1.3b")
             for k in ("prefill step", "train step")}
    records = dryrun_records(whats)
    for arch in ("qwen3-14b", "mamba2-1.3b"):
        s = out["steps"][arch]
        rec = records[f"{arch} prefill step"]
        if rec["kernel_launches"] != s["launches"]:
            raise AssertionError(f"{arch}: the traced prefill step's kernel "
                                 f"ops {rec['kernel_launches']} differ from "
                                 f"the card's launches {s['launches']}")
        out[f"{arch} prefill"] = _say_dryrun_vs_card(
            f"{arch} prefill step ({SERVE_BATCH} x {SERVE_PROMPT})", rec,
            s["ms"], s["peak"], card)
    for arch in ("qwen3-14b", "mamba2-1.3b"):
        r = p16f[arch]
        rec = records[f"{arch} train step"]
        launches = {k: int(round(r["launches"][k]))
                    for k in rec["kernel_launches"]}
        if rec["kernel_launches"] != launches:
            raise AssertionError(f"{arch}: the traced train step's kernel ops "
                                 f"{rec['kernel_launches']} differ from 16f's "
                                 f"launches a step {launches}")
        if r["batch"] != TRAIN_BATCH:
            say(f"{arch}: 16f ran batch {r['batch']}, the trace batch "
                f"{TRAIN_BATCH}: not compared")
            continue
        step_ms = statistics.median(r["step_s"][1:]) * 1e3
        out[f"{arch} train"] = _say_dryrun_vs_card(
            f"{arch} train step (16f, {TRAIN_BATCH} x {TRAIN_SEQ}"
            f"{', %d layers' % TRAIN_QWEN_LAYERS if arch == 'qwen3-14b' else ''})",
            rec, step_ms, r["peak"], card,
            extra=f"; without the batch's token draw ({r['draw_s'] * 1e3:.1f}"
                  f" ms) {rec['model_flops'] / (step_ms * 1e-3 - r['draw_s']) / 1e12:.1f}"
                  f" model TFLOP/s")
    return out


def zoo_config(arch: str, dropless: bool = False):
    """``arch``'s published config cut to ``ZOO_LAYERS[arch]`` layers; with
    ``dropless`` a MoE routes without capacity."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    over = {}
    if ZOO_LAYERS[arch]:
        over["num_layers"] = ZOO_LAYERS[arch]
    if dropless and cfg.num_experts:
        over["moe_dropless"] = True
    return dataclasses.replace(cfg, **over)


def _cast_tree(tree, dtype) -> None:
    """Every floating leaf of a nested dict/list of tensors to ``dtype``,
    in place in its container, one leaf at a time (so that a model's
    weights never live twice)."""
    import torch
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in list(items):
        if isinstance(value, (dict, list)):
            _cast_tree(value, dtype)
        elif torch.is_tensor(value) and value.is_floating_point():
            tree[key] = value.to(dtype)


def zoo_gaps(dev, arch: str, dtypes) -> dict:
    """``serve_gaps`` of ``arch`` at its phase-20 depth (a MoE routing
    dropless) on ``self_consistency_inputs``' weights and prompt, in each
    of ``dtypes`` in turn: the weights are drawn in the first and cast,
    leaf by leaf, to the next (TF32 off in float32).  Asserts one kernel
    launch a mixer layer in forward and prefill, none in decode, and
    finite logits.  Returns {dtype: gaps}."""
    import gc
    import torch
    cfg = dataclasses.replace(zoo_config(arch, dropless=True),
                              dtype=dtypes[0])
    params, toks = self_consistency_inputs(dev, cfg)
    out = {}
    for dtype in dtypes:
        if dtype != cfg.dtype:
            cfg = dataclasses.replace(cfg, dtype=dtype)
            _cast_tree(params, getattr(torch, dtype))
            gc.collect()
            torch.cuda.empty_cache()
        old = _tf32(False, False) if dtype == "float32" else None
        try:
            gaps = serve_gaps(params, cfg, toks)
        finally:
            if old is not None:
                _tf32(*old)
        mix = mixer_launches(cfg)
        for call in ("forward", "prefill", "decode_step"):
            got = {k: gaps["launches"][call][k] for k in mix}
            if got != (mix if call != "decode_step"
                       else dict.fromkeys(mix, 0)):
                raise AssertionError(f"{arch} {dtype}: {call} launches "
                                     f"{got}")
        for name, ok in gaps["finite"].items():
            if not ok:
                raise AssertionError(f"{arch} {dtype}: non-finite {name} "
                                     f"logits")
        out[dtype] = gaps
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _step_grads(dev, cfg, params, batch) -> dict:
    """One train step's gradients at ``params`` (left as they are) on
    ``batch``, taken as ``make_train_step`` takes them (plain autograd of
    ``loss_fn`` over detached leaves), with the launch counts set to 0 just
    before and read just after -> {"loss", "grads" (flat), "s", "peak",
    "above", "launches"}; ``peak`` is ``max_memory_allocated`` over the
    call, ``above`` that less what was allocated when it began (the params
    and any gradients held): the step's own memory."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.ssd_scan import backward as ssd_backward
    from repro_torch.models import loss_fn
    from repro_torch.models.transformer import (flatten_params,
                                                unflatten_params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    ssd_backward.vjp_calls = 0
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    leaves = {k: p.detach().requires_grad_()
              for k, p in flatten_params(params).items()}
    loss = loss_fn(unflatten_params(leaves), cfg, batch)[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    launches["ssd_vjp"] = ssd_backward.vjp_calls
    peak = torch.cuda.max_memory_allocated(dev)
    return {"loss": loss.detach(), "grads": dict(zip(leaves, grads)),
            "s": wall, "peak": peak, "above": peak - base,
            "launches": launches}


def _grads_equal(a: dict, b: dict) -> bool:
    import torch
    return torch.equal(a["loss"], b["loss"]) and all(
        torch.equal(a["grads"][k], b["grads"][k]) for k in b["grads"])


def _float_gap(got: dict, want: dict) -> float:
    """``_leaf_gap`` in float32, a leaf at a time."""
    return max(_leaf_gap({k: got[k].float()}, {k: want[k].float()})
               for k in want)


def _remat_batch(dev, cfg, seq: int) -> dict:
    """Batch 0 of ``run_train``'s synthetic batches at ``seq`` tokens."""
    from repro_torch import rng
    from repro_torch.data import TokenDataset
    from repro_torch.launch.train import synth_lm_batch
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=seq, device=dev)
    return synth_lm_batch(ds, rng.fold_in(rng.PRNGKey(0, dev), 0),
                          TRAIN_BATCH)


def _zoo_remat_gap(dev, cfg) -> dict:
    """The trained MoE arch's gradients under its config's remat against
    remat off, from the same params and batch, beside the remat-off step's
    own run-to-run gap: capacity routing's ``index_add`` sums repeated token
    indices with atomics in no fixed order on the card, so a recompute may
    differ from its forward by an ulp and a near-tied router may send a
    token elsewhere; neither gap is held."""
    import gc
    import torch
    from repro_torch.models import init_model
    from repro_torch.rng import PRNGKey
    params = init_model(PRNGKey(0, dev), cfg, device=dev)
    batch = _remat_batch(dev, cfg, TRAIN_SEQ)
    off = dataclasses.replace(cfg, remat=False)
    ref = _step_grads(dev, off, params, batch)
    again = _step_grads(dev, off, params, batch)
    on = _step_grads(dev, cfg, params, batch)
    out = {"remat_gap": _float_gap(on["grads"], ref["grads"]),
           "run_gap": _float_gap(again["grads"], ref["grads"]),
           "remat_loss_gap": abs(float(on["loss"]) - float(ref["loss"])),
           "run_loss_gap": abs(float(again["loss"]) - float(ref["loss"]))}
    say(f"{ZOO_TRAIN}, one step's gradients at {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"remat {cfg.remat_policy} against remat off within "
        f"{out['remat_gap']:.3e} of each leaf's max |grad| (loss "
        f"{out['remat_loss_gap']:.3e}); remat off against itself "
        f"{out['run_gap']:.3e} (loss {out['run_loss_gap']:.3e}): not held "
        f"(index_add's atomics)")
    del params, ref, again, on
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase20_zoo(dev) -> dict:
    """The arch zoo at full width in bf16: each arch's serving main path
    (``run_serve``, capacity routing), decode ≡ forward, and granite-moe's
    full-width training."""
    import gc
    import math
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serve
    say(f"== 20. the arch zoo at full width on the card (bf16): run_serve("
        f"batch={SERVE_BATCH}, prompt_len={SERVE_PROMPT}, gen={SERVE_GEN}),"
        f" decode ≡ forward, and {ZOO_TRAIN}'s train steps")
    t_phase = time.time()
    out = {}
    for arch, layers in ZOO_LAYERS.items():
        t0 = time.time()
        cfg = zoo_config(arch)
        want = dict.fromkeys(kernels.launch_counts(), 0)
        want.update(mixer_launches(cfg))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        seqs, t_prefill, t_decode = run_serve(
            arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
            reduced=False, device=dev, num_layers=layers)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        if launches != want:
            raise AssertionError(f"{arch}: launches {launches}, expected "
                                 f"{want} (one a mixer layer of the prefill,"
                                 f" none in decode)")
        if seqs.shape != (SERVE_BATCH, SERVE_GEN) or int(seqs.min()) < 0 \
                or int(seqs.max()) >= cfg.vocab_size:
            raise AssertionError(f"{arch}: tokens {tuple(seqs.shape)} out of "
                                 f"range")
        del seqs
        say(f"{arch}: {cfg.num_layers} of {get_config(arch).num_layers} "
            f"layers{', capacity routing' if cfg.num_experts else ''}; "
            f"prefill {t_prefill * 1e3:.1f} ms, decode {t_decode * 1e3:.2f} "
            f"ms/token, peak {peak / 1e9:.2f} GB (max_memory_allocated, the "
            f"weights' init included), launches {launches}")

        gaps = zoo_gaps(dev, arch, ZOO_SELF_DTYPES[arch])
        for dtype, g in gaps.items():
            tol = (SELF_TOL_F32 if dtype == "float32"
                   else SELF_TOL_BF16.get(arch))
            say(f"{arch} {dtype}{' (moe_dropless)' if cfg.num_experts else ''}"
                f", prompt {g['prompt']}: prefill ≡ forward max |diff| "
                f"{g['prefill']:.3e} (relative {g['prefill_rel']:.3e}, limit "
                f"{tol['prefill'] if tol else 'none'}), decode_step ≡ forward "
                f"{g['decode']:.3e} (relative {g['decode_rel']:.3e}, limit "
                f"{tol['decode'] if tol else 'none'}); |logits| up to "
                f"{g['scale']:.2f}")
            for name in ("prefill", "decode"):
                if tol and not g[name + "_rel"] <= tol[name]:
                    raise AssertionError(
                        f"{arch} {dtype}: {name} vs forward differs by "
                        f"{g[name]} (relative {g[name + '_rel']}) over "
                        f"{tol[name]}")
        out[arch] = {"layers": cfg.num_layers, "launches": launches,
                     "t_prefill": t_prefill, "t_decode": t_decode,
                     "peak": peak,
                     "gaps": {dt: {k: g[k] for k in ("prefill_rel",
                                                     "decode_rel")}
                              for dt, g in gaps.items()}}
        say(f"{arch}: phase 20 wall {time.time() - t0:.1f} s")

    t0 = time.time()
    cfg = zoo_config(ZOO_TRAIN)
    r = _train_run(dev, ZOO_TRAIN)
    warm = r["step_s"][1:]
    tok_s = r["batch"] * TRAIN_SEQ / statistics.median(warm)
    want = train_launches(cfg)
    say(f"{ZOO_TRAIN} run_train at full width and depth, capacity routing: "
        f"batch {r['batch']} x {TRAIN_SEQ}; losses "
        f"{[round(x, 4) for x in r['losses']]}; step "
        f"{[f'{x:.3f}' for x in r['step_s']]} s (first with the kernels' "
        f"first launches), {tok_s:.0f} tokens/s warm; the batch's token draw "
        f"alone {r['draw_s']:.3f} s; peak {r['peak'] / 1e9:.2f} GB; launches"
        f" a step {r['launches']}; wall {time.time() - t0:.1f} s")
    if not all(math.isfinite(x) for x in r["losses"]) or any(
            r["launches"][k] != n for k, n in want.items()):
        raise AssertionError(f"{ZOO_TRAIN} training: losses {r['losses']}, "
                             f"launches {r['launches']} (expected {want} a "
                             f"step, one microbatch)")
    out["train"] = {"arch": ZOO_TRAIN, "step_s": r["step_s"],
                    "tokens_s": tok_s, "peak": r["peak"],
                    "launches": r["launches"], "losses": r["losses"],
                    **_zoo_remat_gap(dev, cfg)}
    say(f"phase 20 wall {time.time() - t_phase:.1f} s")
    return out


# Phase 21: the VLM and audio pathways.  phi-3-vision-4.2b served at full
# width and depth (32 layers, 3.74 B parameters, 7.5 GB in bf16): 4 prompts
# of 1024 patches + 1024 tokens; whisper-tiny at its published contexts
# (arXiv:2212.04356: 1500 encoder frames, 448 decoder tokens), served to 16
# prompts and trained on 16 x 448 tokens, AdamW 3e-4, clip 1.0.
VLM, AUDIO = "phi-3-vision-4.2b", "whisper-tiny"
VLM_BATCH, VLM_PROMPT = 4, 1024
AUDIO_BATCH, AUDIO_CONTEXT = 16, 448
# Phase 21b-c's decode ≡ forward checks, as phase 20's (max |diff| / (1 +
# |forward|) of the logits, prompt 200, seed 11, the stub inputs from seed
# 11); float32 on the same weights cast up, TF32 off, at SELF_TOL_F32.  The
# bf16 limits lie between the sound readings and the known faults' of
# ``python3 scripts/torch_serve_drift.py --modal`` on H100 80GB HBM3 at
# 700 W (PERF.md §6, PR 25).  phi-3-vision-4.2b: prefill bit-equal to
# forward; decode 0.0235 sound, 0.0384 with the decode RoPE one position
# off, 0.222 with decode positions that leave out the 1024 patches.
# whisper-tiny: prefill 0.0038 (cuBLAS rounds calls of other row counts
# apart); decode 0.0162 sound, 0.125 when a decode step's cross-attention
# reads half the frames, 3.68 when every layer reads the first layer's
# cross K/V.  (On NumPy-made stub inputs the same readings were 0.0215 and
# 0.0322 for phi-3-vision-4.2b's sound and RoPE-fault decode.)
MODAL_SELF_TOL_BF16 = {VLM: {"prefill": 1e-2, "decode": 0.03},
                       AUDIO: {"prefill": 1e-2, "decode": 0.05}}
# Phase 21e: the assigned pairs the card can run a step of (train_4k's
# traces take minutes of host CPU; ``python -m repro_torch.launch.dryrun``
# records them).
MODAL_DRYRUN_SHAPES = ("long_500k", "decode_32k", "prefill_32k")
# Phase 21f: phi-3-vision-4.2b trained at full width and depth, AdamW 3e-4,
# clip 1.0, at the first batch of VLM_TRAIN (rows of VLM_PROMPT patches +
# VLM_PROMPT tokens, the serving shape first) whose train step the dry-run
# estimates within the card's memory, for VLM_TRAIN_STEPS steps.  Its first
# five losses rise (10.904, 10.940, 10.848, 11.179, 11.133 on H100 80GB HBM3
# at 700 W): AdamW's first steps, with no warm-up, over batches that
# differ.  With the plain attention in place of the kernels
# (scripts/torch_train_plain_attention.py) the losses of a 4-layer cut
# agree with the kernels' within 2e-4 over six steps, so the rise is the
# recipe's, not the kernels'; at this batch and seed the tenth loss is
# below the first (10.785).
VLM_TRAIN = (4, 2, 1)
VLM_TRAIN_STEPS = 10


def _attention_times(dev, b, s, h, kvh, d, causal: bool, seed: int) -> dict:
    """The bf16 forward at (b, s, h/kvh, d): held against its plain version
    (one bf16 ulp), then timed beside its bound, the plain version and
    SDPA; float32 at the same shape held at FLASH_F32_TOL (TF32 off)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import (gqa_attention_ref,
                                                     gqa_flash_attention)
    from repro_torch.kernels.flash_attention.flash_attention import launch
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g, device=dev)
    k, v = (torch.randn((b, s, kvh, d), generator=g, device=dev)
            for _ in range(2))
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        kernels.reset_launch_counts()
        got = gqa_flash_attention(qd, kd, vd, causal=causal).float()
        torch.cuda.synchronize()
        if kernels.launch_counts()["flash_attention"] != 1:
            raise AssertionError("flash_attention: not one launch")
        want = gqa_attention_ref(qd, kd, vd, causal).float()
        err = (got - want).abs()
        tol = (FLASH_F32_TOL * (1 + want.abs()) if dtype == torch.float32
               else 2.0 ** -7 * want.abs() + 1e-5)
        if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {(b, s, h, kvh, d)} "
                                 f"{dtype} causal={causal}: max |diff| "
                                 f"{err.max().item()}")
        errs[str(dtype).replace("torch.", "")] = err.max().item()
        del got, want, err
    q, k, v = (x.bfloat16() for x in (q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = {"shape": [b, s, h, kvh, d], "causal": causal, "err": errs,
           "ms": time_ms(lambda: launch(q, k, v, causal=causal, window=0)),
           "plain": time_ms(lambda: gqa_attention_ref(q, k, v, causal),
                            reps=2, trials=5),
           "lib": time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=causal, enable_gqa=h != kvh))}
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    pairs = s * (s + 1) // 2 if causal else s * s   # live (q, k) pairs
    ops = 4 * b * h * d * pairs
    out["bound"], out["by"] = bound(nbytes, ops, BF16_OPS_PER_S)
    say(f"flash_attention (B={b}, S={s}, H={h}, KV={kvh}, D={d}, causal="
        f"{causal}): bf16 max abs err {errs['bfloat16']:.3e}, float32 "
        f"{errs['float32']:.3e}; bf16 kernel {out['ms']:.4f} ms, bound "
        f"{out['bound']:.4f} ms ({out['by']}: {ops / 1e9:.1f} GFLOP at 989 "
        f"TFLOP/s bf16, {nbytes / 1e6:.1f} MB), plain {out['plain']:.4f} ms,"
        f" scaled_dot_product_attention {out['lib']:.4f} ms; "
        f"{ops / (out['ms'] * 1e-3) / 1e12:.0f} TFLOP/s on the live pairs")
    return out


def _modal_serve(dev, arch: str, batch: int, prompt: int) -> dict:
    """``run_serve`` of ``arch`` at full width and depth with the launch
    counts set to 0 just before and read just after, then decode ≡
    forward in bf16 and in float32 on the same weights cast up."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serve
    cfg = get_config(arch)
    want = dict.fromkeys(kernels.launch_counts(), 0)
    want["flash_attention"] = mixer_launches(cfg)["flash_attention"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    seqs, t_prefill, t_decode = run_serve(arch, batch=batch,
                                          prompt_len=prompt, gen=SERVE_GEN,
                                          reduced=False, device=dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, expected {want} "
                             f"(one an attention layer of the prefill, the "
                             f"encoder's included; none in decode)")
    if seqs.shape != (batch, SERVE_GEN) or int(seqs.min()) < 0 \
            or int(seqs.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch}: tokens {tuple(seqs.shape)} out of "
                             f"range")
    del seqs
    from repro_torch.launch.steps import param_count
    say(f"{arch}: run_serve(batch={batch}, prompt_len={prompt}, gen="
        f"{SERVE_GEN}, reduced=False), {cfg.num_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}"
        f", {param_count(cfg) / 1e9:.3f} B params: prefill "
        f"{t_prefill * 1e3:.1f} ms, decode {t_decode * 1e3:.2f} ms/token, "
        f"peak {peak / 1e9:.2f} GB (the weights' init included), launches "
        f"{launches}")
    # decode ≡ forward, bf16 then float32 on the same weights cast up.
    cfg16 = cfg
    params, toks = self_consistency_inputs(dev, cfg16)
    extra = modality_batch(cfg16, toks.shape[0], seed=11, device=dev)
    gaps = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg16, dtype=dtype)
        if dtype == "float32":
            _cast_tree(params, torch.float32)
            gc.collect()
            torch.cuda.empty_cache()
        old = _tf32(False, False) if dtype == "float32" else None
        try:
            g = serve_gaps(params, c, toks, extra)
        finally:
            if old is not None:
                _tf32(*old)
        mix = mixer_launches(c)["flash_attention"]
        got = {call: g["launches"][call]["flash_attention"]
               for call in ("forward", "prefill", "decode_step")}
        if got != {"forward": mix, "prefill": mix, "decode_step": 0}:
            raise AssertionError(f"{arch} {dtype}: launches per call {got}")
        if not all(g["finite"].values()):
            raise AssertionError(f"{arch} {dtype}: non-finite logits "
                                 f"{g['finite']}")
        tol = (SELF_TOL_F32 if dtype == "float32"
               else MODAL_SELF_TOL_BF16[arch])
        say(f"{arch} {dtype}, prompt {g['prompt']}: prefill ≡ forward max "
            f"|diff| {g['prefill']:.3e} (relative {g['prefill_rel']:.3e}, "
            f"limit {tol['prefill']}), decode_step ≡ forward {g['decode']:.3e}"
            f" (relative {g['decode_rel']:.3e}, limit {tol['decode']}); "
            f"|logits| up to {g['scale']:.2f}")
        for name in ("prefill", "decode"):
            if not g[name + "_rel"] <= tol[name]:
                raise AssertionError(f"{arch} {dtype}: {name} vs forward "
                                     f"differs by {g[name + '_rel']} over "
                                     f"{tol[name]}")
        gaps[dtype] = {k: g[k] for k in ("prefill_rel", "decode_rel")}
    del params, toks, extra
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "t_prefill": t_prefill,
            "t_decode": t_decode, "peak": peak, "gaps": gaps}


def _reduced_grads(dev, what: str, cfg, seed: int) -> float:
    """``cfg``'s float32 model gradients on the card against the CPU (TF32
    off), within GRAD_TOL of each leaf's largest magnitude, with one
    ``flash_attention`` and one ``flash_attention_bwd`` launch an attention
    layer -> the gap."""
    import numpy as np
    import torch
    from repro_torch import kernels, rng
    old = _tf32(False, False)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 200)))
    extra = modality_batch(cfg, 2, seed=seed)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = _lm_grads(cfg, dev, rng.PRNGKey(seed), toks, _targets(toks), extra)
    launches = kernels.launch_counts()
    want = _lm_grads(cfg, torch.device("cpu"), rng.PRNGKey(seed), toks,
                     _targets(toks), extra)
    _tf32(*old)
    gap = _leaf_gap(got, want)
    zero = [k for k in want if not want[k].abs().max() > 0]
    say(f"{what} reduced float32 gradients (head_dim "
        f"{cfg.resolved_head_dim}, {len(want)} leaves): card vs CPU within "
        f"{gap:.2e} of each leaf's max |grad| (limit {GRAD_TOL:.0e}); "
        f"launches {launches}")
    attn = mixer_launches(cfg)["flash_attention"]
    if not gap <= GRAD_TOL or zero or (
            launches["flash_attention"],
            launches["flash_attention_bwd"]) != (attn, attn):
        raise AssertionError(f"{what}: card gradients differ from the "
                             f"CPU's by {gap}, zero leaves {zero}, launches "
                             f"{launches}")
    return gap


def _train_full(dev, arch: str, batch: int, seq: int,
                steps: int = TRAIN_STEPS) -> dict:
    """``run_train`` of ``arch`` at full width and depth, ``steps`` steps
    of ``batch`` x ``seq`` text tokens (a VLM's patches before them), with
    the launch counts set to 0 just before and read just after: finite,
    falling losses and ``train_launches(cfg)`` a step (one
    ``flash_attention_bwd`` launch an attention layer, its forward twice
    where the config rematerialises); then the step's synthetic batch
    alone."""
    import gc
    import math
    import torch
    from repro_torch import kernels, rng
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, modality_inputs
    from repro_torch.launch.train import run_train, synth_lm_batch
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    times = []
    losses = run_train(arch, steps, batch, seq, reduced=False,
                       device=dev, step_times=times, log_every=steps)
    launches = {k: v / steps for k, v in kernels.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(dev)
    tok_s = batch * seq / statistics.median(times[1:])
    want = train_launches(cfg)
    # A step's synthetic batch alone: the categorical draw hashes batch x
    # seq x vocab gumbels, the stub inputs (a VLM's patches, an
    # encoder-decoder's frames) are normals.
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=seq, device=dev)
    draws = []
    for i in range(3):
        key = rng.fold_in(rng.PRNGKey(0, dev), i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synth_lm_batch(ds, key, batch)
        modality_inputs(cfg, key, batch)
        torch.cuda.synchronize()
        draws.append(time.perf_counter() - t0)
    draw_s = statistics.median(draws)
    parts = [f"{cfg.num_layers} layers"]
    if cfg.is_encoder_decoder:
        parts.append(f"{cfg.encoder_layers} encoder layers over "
                     f"{cfg.num_frames} frames")
    if patch_tokens(cfg):
        parts.append(f"{patch_tokens(cfg)} patches a row")
    say(f"{arch} run_train at full width and depth ({', '.join(parts)}): "
        f"batch {batch} x {seq}; losses "
        f"{[round(x, 4) for x in losses]}; step "
        f"{[f'{x:.3f}' for x in times]} s (first with the kernels' first "
        f"launches), {tok_s:.0f} text tokens/s warm; of a step, the batch's "
        f"draws alone {draw_s:.3f} s; peak {peak / 1e9:.2f} GB; launches a "
        f"step {launches}")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0] \
            or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{arch} training: losses {losses}, launches "
                             f"{launches} (expected {want} a step)")
    return {"batch": batch, "seq": seq, "steps": steps, "losses": losses,
            "step_s": times,
            "tokens_s": tok_s, "peak": peak, "launches": launches,
            "draw_s": draw_s}


def _audio_train(dev) -> dict:
    """(d) whisper-tiny's model gradients card against CPU at its reduced
    config (TF32 off), then ``run_train`` at full width and depth."""
    from repro_torch.configs import get_config
    gap = _reduced_grads(dev, AUDIO,
                         get_config(AUDIO).reduced(dtype="float32"), 3)
    return {"grad_gap": gap,
            **_train_full(dev, AUDIO, AUDIO_BATCH, AUDIO_CONTEXT)}


def _vlm_train(dev, records: dict) -> dict:
    """(f) the attention backward at head_dim 96 and 192 on a model:
    phi-3-vision-4.2b's and nemotron-4-340b's reduced float32 gradients
    card against CPU at their published head_dims; then phi-3-vision-4.2b
    trained at full width and depth at the largest batch of VLM_TRAIN
    that the dry-run (the background process) says fits one card."""
    from repro_torch.configs import get_config
    t0 = time.time()
    out = {"grad_gap_d96": _reduced_grads(
        dev, VLM, get_config(VLM).reduced(dtype="float32", head_dim=96), 5),
        "grad_gap_d192": _reduced_grads(
            dev, "nemotron-4-340b", get_config("nemotron-4-340b").reduced(
                dtype="float32", head_dim=192), 6)}
    fits = {}
    for b in VLM_TRAIN:
        rec = records.get(f"{VLM} train b{b}")
        if rec is None:
            continue
        fits[b] = rec["peak_memory_per_device"]
        say(f"dry-run {VLM} train step, batch {b} x ({VLM_PROMPT} patches + "
            f"{VLM_PROMPT} tokens): estimated peak "
            f"{rec['peak_memory_per_device'] / 1e9:.2f} GB, fits_one_card="
            f"{rec['fits_one_card']}, launches {rec['kernel_launches']}")
        if rec["fits_one_card"]:
            break
    else:
        raise AssertionError(f"{VLM}: no batch of {VLM_TRAIN} fits one card "
                             f"by the dry-run ({fits})")
    out.update(_train_full(dev, VLM, b, VLM_PROMPT, VLM_TRAIN_STEPS),
               estimate=fits[b])
    say(f"{VLM} trained at batch {b}: peak {out['peak'] / 1e9:.2f} GB against"
        f" the dry-run's {fits[b] / 1e9:.2f} GB "
        f"({out['peak'] / fits[b] - 1:+.1%}); the draws "
        f"{out['draw_s'] / statistics.median(out['step_s'][1:]):.1%} of a "
        f"warm step; 21f wall {time.time() - t0:.1f} s")
    return out


def _modal_dryrun(dev, records: dict) -> dict:
    """(e) the dry-run's verdict for both archs at the assigned prefill and
    decode shapes (traced in the background process, DRYRUN_SCRIPT; the
    train_4k pairs by the CPU CLI), and one warm step of each pair that it
    marks fits_one_card."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import (config_for_shape, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models import init_caches, init_model
    from repro_torch.rng import PRNGKey
    out = {}
    for arch in (VLM, AUDIO):
        params = None
        for name in MODAL_DRYRUN_SHAPES:
            shape, rec = SHAPES[name], records[f"{arch} {name}"]
            row = {"fits": rec["fits_one_card"],
                   "estimate": rec["peak_memory_per_device"],
                   "launches": {k: v for k, v in
                                rec["kernel_launches"].items() if v}}
            if rec["fits_one_card"]:
                cfg = config_for_shape(get_config(arch), shape)
                if params is None:
                    params = init_model(PRNGKey(21, dev), get_config(arch),
                                        device=dev)
                b, sl = shape.global_batch, shape.seq_len
                g = np.random.default_rng(21)
                if shape.kind == "decode":
                    step, _ = make_serve_step(cfg, shape)
                    caches = init_caches(cfg, b, sl, dev)
                    for c in cache_layers(caches):
                        if "idx" in c:
                            c["idx"] = sl - 1    # a full cache
                    toks = torch.from_numpy(g.integers(
                        0, cfg.vocab_size, (b,)).astype(np.int32)).to(dev)
                    fn = lambda: step(params, toks, caches)  # noqa: E731
                else:
                    step, _ = make_prefill_step(cfg, shape)
                    text = sl - patch_tokens(cfg)
                    batch = {"tokens": torch.from_numpy(g.integers(
                        0, cfg.vocab_size, (b, text)).astype(np.int32)).to(
                            dev), **modality_batch(cfg, b, 21, dev)}
                    fn = lambda: step(params, batch)         # noqa: E731
                try:
                    ms, peak, res = _warm_ms(dev, fn, reps=1)
                except torch.cuda.OutOfMemoryError as e:
                    raise AssertionError(f"{arch} {name}: the dry-run marks "
                                         f"it as fitting one card, and it "
                                         f"ran out of memory: {e}") from e
                del res, fn
                row.update(ms=ms, peak=peak)
                gc.collect()
                torch.cuda.empty_cache()
            out[f"{arch} {name}"] = row
            say(f"dry-run {arch} x {name} ({shape.kind}, batch "
                f"{shape.global_batch}, seq {shape.seq_len}): fits_one_card="
                f"{row['fits']}, estimated peak {row['estimate'] / 1e9:.2f} "
                f"GB, launches {row['launches']}"
                + (f"; one warm step {row['ms']:.2f} ms, peak "
                   f"{row['peak'] / 1e9:.2f} GB (max_memory_allocated, "
                   f"{row['peak'] / row['estimate'] - 1:+.1%})"
                   if "ms" in row else ""))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase21_modal(dev, records: dict) -> dict:
    """The VLM and audio pathways on the card: (a) the kernel at their new
    shapes, (b) phi-3-vision-4.2b and (c) whisper-tiny served, (d)
    whisper-tiny trained, (e) the dry-run's verdicts and warm steps, (f)
    the attention backward at head_dim 96 and 192 on a model and
    phi-3-vision-4.2b trained."""
    say("== 21. the VLM and audio pathways: phi-3-vision-4.2b and "
        "whisper-tiny at full width")
    t_phase = time.time()
    out = {}
    say("-- 21a. flash_attention at head_dim 96 and without the causal mask")
    out["d96"] = _attention_times(dev, VLM_BATCH, 2 * VLM_PROMPT, 32, 32, 96,
                                  True, seed=211)
    out["noncausal"] = _attention_times(dev, AUDIO_BATCH, 1500, 6, 6, 64,
                                        False, seed=212)
    say("-- 21b. phi-3-vision-4.2b served at full width and depth")
    out[VLM] = _modal_serve(dev, VLM, VLM_BATCH, VLM_PROMPT)
    say("-- 21c. whisper-tiny served at its published contexts")
    out[AUDIO] = _modal_serve(dev, AUDIO, AUDIO_BATCH, AUDIO_CONTEXT)
    say("-- 21d. whisper-tiny trained")
    out["train"] = _audio_train(dev)
    say("-- 21e. the dry-run at the assigned shapes")
    out["dryrun"] = _modal_dryrun(dev, records)
    say("-- 21f. the attention backward at head_dim 96 and 192 on a model; "
        "phi-3-vision-4.2b trained")
    out["vlm_train"] = _vlm_train(dev, records)
    say(f"phase 21 wall {time.time() - t_phase:.1f} s")
    return out


# Phase 22: the reference's activation rematerialisation (cfg.remat,
# remat_policy full | dots) in the train step at full width: mamba2-1.3b at
# full depth and qwen3-14b cut to TRAIN_QWEN_LAYERS layers.  (a) one step's
# gradients at phase 16f's TRAIN_BATCH x TRAIN_SEQ from the same params and
# batch under each policy and without remat, held bit-equal (the recompute
# runs the same kernels on the same values); where the remat-off step is
# not bit-equal to itself run to run, a library kernel on the path is
# nondeterministic, and the remat gap is held to REMAT_NOISE times that
# run-to-run gap instead.  (b) REMAT_LONG_STEPS train steps under ``full``
# at TRAIN_BATCH x REMAT_LONG_SEQ, then one step without remat at that shape
# (mamba2-1.3b's the dry-run puts at 186 GB; qwen3-14b's at 72 GB, which
# the card's allocations exceed by a third at this shape under remat).
REMAT_POLICIES = ("full", "dots")
REMAT_NOISE = 2.0
REMAT_LONG_SEQ = 4096
REMAT_LONG_STEPS = 2


def _remat_arch(dev, arch: str, layers) -> dict:
    """Phase 22 (a) and (b) for one arch; see REMAT_POLICIES."""
    import gc
    import math
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model
    from repro_torch.models.transformer import flatten_params
    from repro_torch.rng import PRNGKey
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = init_model(PRNGKey(0, dev), cfg, device=dev)
    batch = _remat_batch(dev, cfg, TRAIN_SEQ)
    torch.cuda.synchronize()
    what = f"{arch} ({cfg.num_layers} layers)"
    say(f"-- 22a. {what}: weights and batch drawn in "
        f"{time.perf_counter() - t0:.1f} s; one step's gradients at "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}")
    off = dataclasses.replace(cfg, remat=False)
    # The first call also warms the path up; the second is the one timed.
    ref = _step_grads(dev, off, params, batch)
    again = _step_grads(dev, off, params, batch)
    deterministic = _grads_equal(again, ref)
    run_gap = _float_gap(again["grads"], ref["grads"])
    out = {"layers": cfg.num_layers, "run_gap": run_gap,
           "deterministic": deterministic}
    for policy in ("off",) + REMAT_POLICIES:
        r = again if policy == "off" else _step_grads(
            dev, dataclasses.replace(cfg, remat_policy=policy), params, batch)
        row = {k: r[k] for k in ("s", "peak", "above", "launches")}
        row.update(equal=_grads_equal(r, ref),
                   gap=_float_gap(r["grads"], ref["grads"]))
        out[policy] = row
        del r
        say(f"{what} remat {policy}: one step's gradients "
            f"{row['s'] * 1e3:.1f} ms, peak {row['peak'] / 1e9:.2f} GB "
            f"({row['above'] / 1e9:.2f} GB above the params and the "
            f"gradients held before it), "
            f"launches { {k: v for k, v in row['launches'].items() if v} }"
            f", bit-equal to remat off: {row['equal']} (gap "
            f"{row['gap']:.3e})")
        want = train_launches(off if policy == "off" else cfg)
        if any(row["launches"][k] != n for k, n in want.items()) \
                or row["launches"]["ssd_vjp"]:
            raise AssertionError(f"{what} remat {policy}: launches "
                                 f"{row['launches']}, expected {want} and "
                                 f"no plain vjp")
        if deterministic and not row["equal"]:
            raise AssertionError(f"{what} remat {policy}: gradients differ "
                                 f"from remat off by {row['gap']} of a "
                                 f"leaf's max |grad|; the step without "
                                 f"remat is bit-equal run to run")
        if not deterministic and not row["gap"] <= REMAT_NOISE * run_gap:
            raise AssertionError(f"{what} remat {policy}: gap {row['gap']} "
                                 f"over {REMAT_NOISE} x the run-to-run "
                                 f"{run_gap}")
    say(f"{what}: remat off against itself bit-equal: {deterministic} "
        f"(gap {run_gap:.3e})")
    if not out["full"]["above"] < out["off"]["above"]:
        raise AssertionError(f"{what}: the step's own peak "
                             f"{out['full']['above']} under remat full, "
                             f"{out['off']['above']} without")
    del ref, again
    gc.collect()
    torch.cuda.empty_cache()

    say(f"-- 22b. {what}: {REMAT_LONG_STEPS} train steps at {TRAIN_BATCH} x "
        f"{REMAT_LONG_SEQ} under remat full")
    # The batch before the moments: the synthetic draw hashes a row's
    # REMAT_LONG_SEQ x vocab gumbels at once (48 GB of int64 temporaries at
    # qwen3-14b's vocabulary), more than the step itself needs.
    long_batch = _remat_batch(dev, cfg, REMAT_LONG_SEQ)
    step, opt = make_train_step(cfg, InputShape(
        "remat_long", REMAT_LONG_SEQ, TRAIN_BATCH, "train"), microbatches=1)
    state = opt.init(flatten_params(params))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(REMAT_LONG_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, long_batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: v / REMAT_LONG_STEPS
                for k, v in kernels.launch_counts().items()}
    say(f"{what} at {TRAIN_BATCH} x {REMAT_LONG_SEQ}, remat full: losses "
        f"{[round(x, 4) for x in losses]}; steps "
        f"{[f'{x:.3f}' for x in times]} s; peak {peak / 1e9:.2f} GB "
        f"(params, AdamW moments and the step); launches a step "
        f"{ {k: v for k, v in launches.items() if v} }")
    want = train_launches(cfg)
    if not all(math.isfinite(x) for x in losses) or any(
            launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{what} at {REMAT_LONG_SEQ}: losses {losses}, "
                             f"launches {launches}, expected {want}")
    out["long"] = {"losses": losses, "step_s": times, "peak": peak,
                   "launches": launches, "off_peak": None}
    # The same step without remat, from where the two left off: its peak,
    # or where it ran out of memory (read, not held).
    step, _ = make_train_step(off, InputShape(
        "remat_long", REMAT_LONG_SEQ, TRAIN_BATCH, "train"), microbatches=1)
    del m
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        params, state, m = step(params, state, long_batch)
        float(m["loss"])
        out["long"]["off_peak"] = torch.cuda.max_memory_allocated(dev)
        say(f"{what} at {TRAIN_BATCH} x {REMAT_LONG_SEQ} without remat: "
            f"one step, peak {out['long']['off_peak'] / 1e9:.2f} GB")
    except torch.cuda.OutOfMemoryError:
        say(f"{what} at {TRAIN_BATCH} x {REMAT_LONG_SEQ} without remat: out "
            f"of memory ({torch.cuda.max_memory_allocated(dev) / 1e9:.2f} "
            f"GB allocated at the failed allocation)")
    del params, state, long_batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase22_remat(dev, card: str, zoo_train: dict) -> dict:
    """The reference's activation rematerialisation on the card: (a) the
    gradients under each policy against none, (b) steps at 4 x 4096 under
    ``full``, (c) phase 20's MoE remat gap."""
    say("== 22. remat: the train step's activation rematerialisation "
        f"(remat_policy {' | '.join(REMAT_POLICIES)}) at full width")
    t_phase = time.time()
    out = {arch: _remat_arch(dev, arch, layers)
           for arch, layers in (("mamba2-1.3b", None),
                                ("qwen3-14b", TRAIN_QWEN_LAYERS))}
    say(f"-- 22c. {ZOO_TRAIN} (phase 20): remat full against off "
        f"{zoo_train['remat_gap']:.3e} of each leaf's max |grad|, off "
        f"against itself {zoo_train['run_gap']:.3e}; losses "
        f"{zoo_train['remat_loss_gap']:.3e} and "
        f"{zoo_train['run_loss_gap']:.3e} apart")
    say(f"phase 22 wall {time.time() - t_phase:.1f} s ({card})")
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if os.environ.get("REPRO_COMPUTE_BACKEND"):
        # Any value would send the FL dispatch to the reference formulas (or
        # raise), and the run would skip the kernels it checks.
        print("chip_smoke: REPRO_COMPUTE_BACKEND is set; unset it",
              file=sys.stderr)
        return 3
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

    atexit.register(stop_background)
    start_dryrun()
    say(f"phase 19's dry-run traces started in the background: "
        f"{DRYRUN_LOG.relative_to(ROOT)}")

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
            "ssd_scan": 0, "ssd_scan_bwd": 0}
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

    flash_err, flash_f32_err = phase8_flash(dev)
    ssd_err = phase9_ssd(dev)
    phase10_serve_card_vs_cpu(dev)
    served = phase11_serve(dev)
    times = phase12_times(dev)
    fa, ssd = times["flash_attention"], times["ssd_scan"]
    fa192, ssd_jamba = times["flash_d192"], times["ssd_jamba"]
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
    ssd_bwd = p16bd["ssd_bwd"]
    phase16c_vmap_grad(dev)
    p16e = phase16e_lm_fl(dev)
    p16f = phase16f_full_width(dev)
    p17 = phase17_sharded(dev)

    phase18a_cli(dev, card)
    phase18b_registries(dev, card)
    phase18c_validate(dev, card)
    phase18d_extension(dev, card)
    phase18e_refusal(dev, card)
    phase19(dev, card, p16f)
    p20 = phase20_zoo(dev)
    p21 = phase21_modal(dev, dryrun_records(
        [f"{a} {s}" for a in (VLM, AUDIO) for s in MODAL_DRYRUN_SHAPES]
        + [f"{VLM} train"]))
    stop_background()
    p22 = phase22_remat(dev, card, p20["train"])

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
         "library_ms": fa["lib"], "lse_ms": fa["lse_ms"],
         "d192_shape": [SERVE_BATCH, SERVE_PROMPT, 96, 8, 192],
         "d192_ms": fa192["ms"], "d192_plain_ms": fa192["plain"],
         "d192_bound_ms": fa192["bound"], "d192_bound_by": fa192["by"],
         "d192_library_ms": fa192["lib"],
         "zoo_launches": {a: r["launches"]["flash_attention"]
                          for a, r in p20.items() if a != "train"},
         **{f"{key}_{field}": p21[key][src]
            for key in ("d96", "noncausal")
            for field, src in (("shape", "shape"), ("ms", "ms"),
                               ("plain_ms", "plain"), ("bound_ms", "bound"),
                               ("bound_by", "by"), ("library_ms", "lib"),
                               ("max_abs_err", "err"))},
         "modal_launches": {a: p21[a]["launches"]["flash_attention"]
                            for a in (VLM, AUDIO)},
         "audio_train_launches": int(p21["train"]["launches"][
             "flash_attention"] * TRAIN_STEPS),
         "vlm_train_launches": int(p21["vlm_train"]["launches"][
             "flash_attention"] * VLM_TRAIN_STEPS),
         "remat_launches": {p: p22["qwen3-14b"][p]["launches"][
             "flash_attention"] for p in ("off",) + REMAT_POLICIES},
         "remat_long_launches": int(p22["qwen3-14b"]["long"]["launches"][
             "flash_attention"] * REMAT_LONG_STEPS)},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:71",
         "launches": served["mamba2-1.3b"]["launches"],
         "max_abs_err": ssd_err, "ms": ssd["ms"], "plain_ms": ssd["plain"],
         "bound_ms": ssd["bound"], "bound_by": ssd["by"],
         "library_ms": ssd["lib"],
         "train_launches": p16f["mamba2-1.3b"]["launches"]["ssd_scan"],
         "jamba_shape": [SERVE_BATCH, SERVE_PROMPT, 128, 64, 1, 16],
         "jamba_ms": ssd_jamba["ms"], "jamba_plain_ms": ssd_jamba["plain"],
         "jamba_bound_ms": ssd_jamba["bound"],
         "jamba_bound_by": ssd_jamba["by"],
         "jamba_launches": p20["jamba-v0.1-52b"]["launches"]["ssd_scan"],
         "backward_grad_gap": p16bd["ssd_grad_gap"],
         "remat_launches": {p: p22["mamba2-1.3b"][p]["launches"][
             "ssd_scan"] for p in ("off",) + REMAT_POLICIES},
         "remat_long_launches": int(p22["mamba2-1.3b"]["long"]["launches"][
             "ssd_scan"] * REMAT_LONG_STEPS)},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:71 (no TPU "
                     "backward kernel: the reference differentiates XLA's "
                     "_ssd_chunked, src/repro/models/layers.py:462)",
         "launches": int(p16f["mamba2-1.3b"]["launches"]["ssd_scan_bwd"]
                         * TRAIN_STEPS),
         "max_abs_err": ssd_bwd["err"], "ms": ssd_bwd["mamba"]["ms"],
         "plain_ms": ssd_bwd["mamba"]["plain"],
         "bound_ms": ssd_bwd["mamba"]["bound"],
         "bound_by": ssd_bwd["mamba"]["by"],
         "library_ms": ssd_bwd["mamba"]["lib"],
         **{f"jamba_{field}": ssd_bwd["jamba"][src]
            for field, src in (("shape", "shape"), ("ms", "ms"),
                               ("plain_ms", "plain"), ("bound_ms", "bound"),
                               ("bound_by", "by"), ("library_ms", "lib"))}},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:82"
                     " (no TPU backward kernel: the reference differentiates"
                     " XLA attention)",
         "launches": int(p16f["qwen3-14b"]["launches"]["flash_attention_bwd"]
                         * TRAIN_STEPS),
         "max_abs_err": bwd["err"], "ms": bwd["ms"], "plain_ms": bwd["plain"],
         "bound_ms": bwd["bound"], "bound_by": bwd["by"],
         "library_ms": bwd["lib"], "f32_ms": bwd["f32_ms"],
         "fl_launches": p16e["sim"]["launches"]["flash_attention_bwd"],
         "zoo_train_launches": int(p20["train"]["launches"][
             "flash_attention_bwd"] * TRAIN_STEPS),
         "audio_train_launches": int(p21["train"]["launches"][
             "flash_attention_bwd"] * TRAIN_STEPS),
         "vlm_train_launches": int(p21["vlm_train"]["launches"][
             "flash_attention_bwd"] * VLM_TRAIN_STEPS),
         **{f"{key}_{field}": bwd[key][src]
            for key in ("d96", "d192")
            for field, src in (("shape", "shape"), ("ms", "ms"),
                               ("plain_ms", "plain"), ("bound_ms", "bound"),
                               ("bound_by", "by"), ("library_ms", "lib"),
                               ("f32_ms", "f32_ms"))}},
        f32_entry("flash_attention_f32", "fwd", times["f32"],
                  p16e["paper"]["launches"]["flash_attention"],
                  flash_f32_err),
        f32_entry("flash_attention_f32_bwd", "bwd", bwd["f32"],
                  p16e["paper"]["launches"]["flash_attention_bwd"],
                  bwd["f32_err"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
