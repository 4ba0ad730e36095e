#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and print the build time and the compiler's register report;
3. hold ``label_hist`` against its plain version on the card: bit-equal;
4. hold ``weighted_agg`` against its plain version on the card at every leaf
   shape of the paper CNN with K=30 clients, in float32 and bfloat16;
5. run one paper-width FL round (``make_fl_round``, 1 local epoch) on the
   card and on the CPU from the same NumPy-made inputs, with sgd and with
   Adam: selections bit-equal, params within ``SGD_ATOL`` (sgd) and
   updates within ``ADAM_REL`` of their norm (Adam);
6. the main path: ``run_fl_host`` for 3 rounds at paper width (case1b,
   labelwise, fedavg) on the card, with every kernel's launch count set to 0
   just before and read just after (1 label_hist and 8 weighted_agg launches
   a round);
7. time each kernel at the main path's shapes with CUDA events (device
   time per call), beside its bound, its plain version and one PyTorch call
   computing the same function.

The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the checkout's ``src/repro_torch`` beside this file, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth and
# float32 rate outside the tensor cores (both kernels run on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
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
    from repro_torch.kernels.weighted_agg import (weighted_agg_kernel,
                                                  weighted_agg_ref)
    from repro_torch.models import cnn_init

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

    say("== 3. label_hist against its plain version (bit-equal)")
    hist_err = 0.0
    for b, n, c in [(100, 290, 10), (7, 33, 5), (1000, 4096, 62)]:
        rng = np.random.default_rng(b * n + c)
        labels = torch.from_numpy(
            rng.integers(-3, c + 3, (b, n)).astype(np.int32)).to(dev)
        valid = torch.from_numpy(rng.random((b, n)) > 0.1).to(dev)
        got = label_hist_kernel(labels, valid, c)
        want = label_hist_ref(labels, valid, c)
        torch.cuda.synchronize()
        hist_err = max(hist_err, (got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"label_hist differs at {(b, n, c)}")
        say(f"label_hist {(b, n, c)}: equal, {int(want.sum().item())} counts")

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

    say("== 5. one paper-width round on the card against the CPU")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    images, labels, valid = paper_round_inputs(np, cfg, seed=0)
    loss_fn = get_workload("cnn").make_loss(None)
    init = cnn_init(torch.Generator().manual_seed(0), device="cpu")
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
    want = {"label_hist": rounds, "weighted_agg": rounds * len(leaf_sizes)}
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
    hist_ms = time_ms(lambda: label_hist_kernel(lab0, val, c))
    hist_plain = time_ms(lambda: label_hist_ref(lab0, val, c))
    hist_lib = time_ms(lambda: torch.bincount(flat, minlength=b * c + 1))
    hist_bound, hist_by = bound(lab0.numel() * 4 + val.numel() + b * c * 4,
                                counted)
    say(f"label_hist (B={b}, n={n}, C={c}): kernel {hist_ms:.4f} ms, bound "
        f"{hist_bound:.6f} ms ({hist_by}), plain {hist_plain:.4f} ms, "
        f"bincount {hist_lib:.4f} ms")

    agg = dict.fromkeys(("ms", "plain", "lib", "bytes", "ops"), 0.0)
    for name, size in leaf_sizes.items():
        rng = np.random.default_rng(size)
        x = torch.from_numpy(
            rng.standard_normal((K_CLIENTS, size)).astype(np.float32)).to(dev)
        w = torch.from_numpy(
            rng.uniform(30, 290, K_CLIENTS).astype(np.float32)).to(dev)
        k_ms = time_ms(lambda: weighted_agg_kernel(x, w))
        p_ms = time_ms(lambda: weighted_agg_ref(x, w))
        l_ms = time_ms(lambda: w @ x)
        nbytes = (K_CLIENTS * size + K_CLIENTS + size) * 4
        leaf_bound, _ = bound(nbytes, 2 * K_CLIENTS * size)
        for key, v in (("ms", k_ms), ("plain", p_ms),
                       ("lib", l_ms), ("bytes", nbytes),
                       ("ops", 2 * K_CLIENTS * size)):
            agg[key] += v
        say(f"weighted_agg {name} (K={K_CLIENTS}, N={size}): kernel "
            f"{k_ms:.4f} ms, bound {leaf_bound:.5f} ms, "
            f"plain {p_ms:.4f} ms, s @ stacked {l_ms:.4f} ms")
    agg_bound, agg_by = bound(agg["bytes"], agg["ops"])
    say(f"weighted_agg, one round's {len(leaf_sizes)} launches: kernel "
        f"{agg['ms']:.4f} ms, bound "
        f"{agg_bound:.5f} ms ({agg_by}, {agg['bytes'] / 1e6:.1f} MB), plain "
        f"{agg['plain']:.4f} ms, s @ stacked {agg['lib']:.4f} ms")

    say(f"card: {card}; total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "label_hist", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/label_hist.cu",
         "replaces": "src/repro/kernels/label_hist/label_hist.py:37",
         "launches": launches["label_hist"], "max_abs_err": hist_err,
         "ms": hist_ms, "plain_ms": hist_plain, "bound_ms": hist_bound,
         "bound_by": hist_by, "library_ms": hist_lib},
        {"name": "weighted_agg", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/weighted_agg.cu",
         "replaces": "src/repro/kernels/weighted_agg/weighted_agg.py:28",
         "launches": launches["weighted_agg"], "max_abs_err": agg_err,
         "ms": agg["ms"], "plain_ms": agg["plain"], "bound_ms": agg_bound,
         "bound_by": agg_by, "library_ms": agg["lib"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
