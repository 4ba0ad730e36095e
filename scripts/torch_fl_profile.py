#!/usr/bin/env python3
"""Where the time of one FL round of the port goes on one GPU.

    python3 scripts/torch_fl_profile.py [--rounds-warm 2] [--top 12]
                                        [--out build/fl_profile.json]
    python3 scripts/torch_fl_profile.py --grid [--seeds 5] [--top 16]
                                        [--aggregation NAME] [--attack]
                                        [--out build/fl_grid_profile.json]
    python3 scripts/torch_fl_profile.py --population 1048576 [--top 12]
                                        [--out build/fl_population_profile.json]

Runs ``run_fl_host`` at the paper's width (``configs.FLConfig()``: 100
clients, 30 a round, 4 local epochs of batch 32, Adam; case1b, labelwise,
fedavg) on the card: first ``--rounds-warm`` rounds to warm it up (the
kernel build, cuDNN's algorithm choice, the allocator), then one round under
``torch.profiler``.  Prints the round's wall time, the device time and busy
share, the kernel launches, the device time by kernel, the shares of the
port's two FL kernels, ``label_hist`` and ``weighted_agg``, and the device
time and launches under two ranges: ``host/draw``, the round's data (its
histograms and the threefry/normal image noise of all 100 clients), and
``host/setup``, what the profiled one-round call does before its round (the
CNN init's and the eval set's threefry/normal draws).

With ``--grid`` it profiles one warm round of the batched grid engine
(``fl.sim.GridRun``) at BENCH_sim_grid.json's grid size, 7 cases × (random,
labelwise, kl) × ``--seeds`` seeds with a plan a seed (105 trials by
default), each trial at the paper's width: round 0 warms up (it also sizes
the training chunk, split only where the card lacks the memory), round 1
runs under ``torch.profiler``.  It prints the round's wall time, busy share
and launches, the device time by kernel and by the engine's phases (the ``grid/<phase>`` ranges: ``draw`` is the
threefry/normal image noise), ``label_hist`` at the engine's
(T·100, 290, 10) and ``weighted_agg``'s share, and the peak memory.
``--aggregation`` picks the family (``fedavg`` by default; a clustered one
adds the ``grid/kmeans`` phase and M ``weighted_agg`` launches a round, a
robust one runs its reducer in ``grid/aggregate``), and ``--attack`` turns
on ``chip_smoke.py`` phase 14's adversary (a quarter of the clients poison
at scale −4 and train from the previous round's global).

With ``--population N`` it profiles one warm ``make_population_round``
at N clients with ``benchmarks/population.py``'s settings (blocks of 256,
32 selected, 8 samples a client, SGD, batch 8, 1 local epoch, the
procedural plan; ``chip_smoke.py`` phase 15c): the round's wall time, busy
share, launches, peak memory, the device time by kernel and by step
(``select/labels``: the procedural plan's threefry draws; ``select/hists``,
``select/score``, ``select/merge``: a chunk's histograms, scores and top-k
merge; ``population/draw``, ``population/train``,
``population/aggregate``: the selected clients' payload, training and
two-tier sum).

Needs a CUDA device; writes the numbers as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Substrings of the device-side names of the port's FL kernels.
FL_KERNELS = {"label_hist": "label_hist_kernel",
              "weighted_agg": "weighted_agg"}


def profile_round(rounds_warm: int, top: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import kernels
    from repro_torch.configs import FLConfig
    from repro_torch.core import case_label_plan
    from repro_torch.data import ImageDataset
    from repro_torch.fl import get_workload, run_fl_host

    def traced(fn, name):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    dev = torch.device("cuda")
    cfg = FLConfig()
    plan = case_label_plan("case1b", 0, rounds_warm + 1, cfg.num_clients)
    ds = ImageDataset(device=dev)
    cnn = get_workload("cnn")
    wl = dataclasses.replace(
        cnn, init=traced(cnn.init, "host/setup"),
        eval_set=traced(cnn.eval_set, "host/setup"),
        materialize=traced(cnn.materialize, "host/draw"))
    kw = dict(strategy="labelwise", aggregation="fedavg", ds=ds, workload=wl,
              device=dev)
    warm = run_fl_host(plan[:rounds_warm], cfg, rounds=rounds_warm, **kw)
    torch.cuda.synchronize()
    # The profiled call runs one round: the plan's round after the warm ones.
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hist = run_fl_host(plan[rounds_warm:], cfg, rounds=1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    device, copies_us, launches, ranges = _device_times(prof)
    kernel_us = sum(device.values())
    ranked = sorted(device.items(), key=lambda kv: -kv[1])
    fl = {}
    for short, key in FL_KERNELS.items():
        us = sum(t for name, t in device.items() if key in name)
        fl[short] = {"device_ms": us / 1e3,
                     "share_of_device": us / kernel_us if kernel_us else 0.0,
                     "share_of_wall": us / 1e3 / (wall * 1e3),
                     "launches": counts[short]}
    return {"config": {"num_clients": cfg.num_clients,
                       "clients_per_round": cfg.clients_per_round,
                       "local_epochs": cfg.local_epochs,
                       "batch_size": cfg.batch_size,
                       "optimizer": cfg.optimizer, "case": "case1b",
                       "strategy": "labelwise", "aggregation": "fedavg"},
            "warm_rounds_wall_s": warm.wall_s,
            "round_wall_ms": wall * 1e3,
            "round_loop_wall_ms": hist.wall_s * 1e3,
            "kernel_device_ms": kernel_us / 1e3,
            "copy_device_ms": copies_us / 1e3,
            "busy_share": (kernel_us + copies_us) / 1e3 / (wall * 1e3),
            "kernel_launches": launches,
            "distinct_kernels": len(device),
            "fl_kernels": fl,
            "ranges": {k: {"device_ms": us / 1e3, "launches": n}
                       for k, (us, n) in sorted(ranges.items())},
            "top": [(name[:90], us / 1e3) for name, us in ranked[:top]],
            "accuracy": hist.accuracy, "num_selected": hist.num_selected}


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC")


def _launches_under(ev) -> int:
    return sum(c.name in LAUNCH_CALLS or _launches_under(c)
               for c in ev.cpu_children) if ev.cpu_children else 0


# Prefixes of the profiler ranges the engines open.
RANGES = ("grid/", "host/", "select/", "population/")


def _device_times(prof):
    """(kernel device µs by name, copies µs, kernel launches, [device µs,
    launches] by range of ``RANGES``) from a finished profiler."""
    device, ranges, launches, copies_us = {}, {}, 0, 0.0
    for ev in prof.events():
        if ev.name.startswith(RANGES):
            if ev.device_type.name == "CPU":      # kernels launched inside
                us, n = ranges.get(ev.name, (0.0, 0))
                ranges[ev.name] = (us + ev.device_time_total,
                                   n + _launches_under(ev))
        elif ev.device_type.name == "CUDA":
            if ev.name.startswith(("Memcpy", "Memset")):
                copies_us += ev.device_time_total
            else:
                device[ev.name] = device.get(ev.name, 0.0) + \
                    ev.device_time_total
        elif ev.name in LAUNCH_CALLS:
            launches += 1
    return device, copies_us, launches, ranges


# chip_smoke.py phase 14's adversary.
ATTACK = {"frac": 0.25, "behaviors": ["poison", "stale_update"],
          "scale": -4.0, "tau": 1}


def profile_grid(seeds: int, top: int, aggregation: str = "fedavg",
                 attack: bool = False) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.configs import FLConfig
    from repro_torch.core import CASES
    from repro_torch.data import ImageDataset
    from repro_torch.fl import ExperimentSpec, GridRun, ScenarioSpec

    dev = torch.device("cuda")
    cfg = FLConfig()
    strategies = ("random", "labelwise", "kl")
    seed_list = tuple(range(seeds))
    plans = np.stack([ScenarioSpec.from_case(c, per_seed_plans=True)
                      .lower(cfg, seed_list, 2).plan for c in CASES])
    adversary = ATTACK if attack else None
    adv = (ExperimentSpec(scenarios=(), seeds=seed_list, fl=cfg,
                          adversary=ATTACK).adversary_masks()
           if attack else None)
    grid = GridRun(plans, cfg, strategies=strategies, seeds=seed_list,
                   rounds=2, ds=ImageDataset(device=dev),
                   aggregation=aggregation, adversary=adversary, adv=adv,
                   device=dev)
    t0 = time.perf_counter()
    grid.round(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grid.round(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    res = grid.result(warm_s + wall)
    device, copies_us, launches, ranges = _device_times(prof)
    kernel_us = sum(device.values())
    ranked = sorted(device.items(), key=lambda kv: -kv[1])
    fl = {}
    for short, key in FL_KERNELS.items():
        us = sum(t for name, t in device.items() if key in name)
        fl[short] = {"device_ms": us / 1e3,
                     "share_of_device": us / kernel_us if kernel_us else 0.0,
                     "launches": counts[short]}
    return {"config": {"trials": grid.trials, "cases": list(CASES),
                       "strategies": list(strategies), "seeds": seeds,
                       "num_clients": cfg.num_clients,
                       "clients_per_round": cfg.clients_per_round,
                       "local_epochs": cfg.local_epochs,
                       "batch_size": cfg.batch_size,
                       "optimizer": cfg.optimizer,
                       "aggregation": aggregation, "adversary": adversary,
                       "label_hist_shape": [grid.trials * cfg.num_clients,
                                            plans.shape[-1], 10]},
            "warm_round_s": warm_s, "round_wall_ms": wall * 1e3,
            "kernel_device_ms": kernel_us / 1e3,
            "copy_device_ms": copies_us / 1e3,
            "busy_share": (kernel_us + copies_us) / 1e3 / (wall * 1e3),
            "kernel_launches": launches, "distinct_kernels": len(device),
            "fl_kernels": fl,
            "phases": {k: {"device_ms": us / 1e3, "launches": n}
                       for k, (us, n) in sorted(ranges.items())},
            "chunk_trials": res.meta["chunk_trials"],
            "per_trial_bytes": res.meta["per_trial_bytes"],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "top": [(name[:90], us / 1e3) for name, us in ranked[:top]],
            "num_selected": res.num_selected[..., -1].tolist()}


def main_grid(args, card: str) -> int:
    r = profile_grid(args.seeds, args.top, args.aggregation, args.attack)
    r["card"] = card
    c = r["config"]
    print(f"one warm grid round on {card}: {c['trials']} trials (7 cases x "
          f"{c['strategies']} x {c['seeds']} seeds), each {c['num_clients']}"
          f" clients, {c['clients_per_round']} a round, {c['local_epochs']} "
          f"local epochs of batch {c['batch_size']}, {c['optimizer']}, "
          f"{c['aggregation']}, adversary {c['adversary']}")
    print(f"  wall {r['round_wall_ms']:.1f} ms ({r['round_wall_ms'] / c['trials']:.2f}"
          f" ms a trial; the warm-up round {r['warm_round_s']:.2f} s); "
          f"device: kernels {r['kernel_device_ms']:.2f} ms, copies "
          f"{r['copy_device_ms']:.2f} ms, busy {r['busy_share']:.1%}; "
          f"{r['kernel_launches']} kernel launches of "
          f"{r['distinct_kernels']} kernels")
    print(f"  training chunk {r['chunk_trials']} trials "
          f"({r['per_trial_bytes'] / 1e9:.2f} GB a trial); peak "
          f"torch.cuda.max_memory_allocated {r['peak_bytes'] / 1e9:.2f} GB")
    for name, ph in r["phases"].items():
        print(f"  {name}: {ph['device_ms']:9.3f} ms device, "
              f"{ph['device_ms'] / r['kernel_device_ms']:.2%} of the kernels' "
              f"time, {ph['launches']} launches")
    for name, ms in r["top"]:
        print(f"    {ms:9.3f} ms  {name}")
    for short, f in r["fl_kernels"].items():
        print(f"  {short}: {f['launches']} launch(es), "
              f"{f['device_ms'] * 1e3:.2f} us, {f['share_of_device']:.4%} of "
              f"the device time")
    print(f"  label_hist ran at {tuple(c['label_hist_shape'])}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(r, indent=1))
    print(f"wrote {args.out}")
    return 0


def profile_population(n: int, top: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.data import ImageDataset
    from repro_torch.fl import make_population_round, synthetic_population_plan
    from repro_torch.models import cnn_init
    from repro_torch.rng import PRNGKey

    dev = torch.device("cuda")
    cfg = {"num_clients": n, "block_size": 256, "budget": 32,
           "samples_per_client": 8, "batch_size": 8, "local_epochs": 1,
           "optimizer": "sgd", "strategy": "labelwise"}
    rnd = make_population_round(
        plan_fn=synthetic_population_plan(
            samples_per_client=cfg["samples_per_client"]),
        num_clients=n, block_size=cfg["block_size"],
        strategy=cfg["strategy"], budget=cfg["budget"],
        ds=ImageDataset(device=dev), batch_size=cfg["batch_size"],
        local_epochs=cfg["local_epochs"], optimizer=cfg["optimizer"])
    params = cnn_init(PRNGKey(0), device=dev)
    t0 = time.perf_counter()
    rnd(params, PRNGKey(6))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = rnd(params, PRNGKey(7))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    device, copies_us, launches, ranges = _device_times(prof)
    kernel_us = sum(device.values())
    ranked = sorted(device.items(), key=lambda kv: -kv[1])
    return {"config": {**cfg, "num_blocks": rnd.num_blocks},
            "warm_round_s": warm_s, "round_wall_ms": wall * 1e3,
            "kernel_device_ms": kernel_us / 1e3,
            "copy_device_ms": copies_us / 1e3,
            "busy_share": (kernel_us + copies_us) / 1e3 / (wall * 1e3),
            "kernel_launches": launches, "distinct_kernels": len(device),
            "fl_kernel_launches": {k: counts[k] for k in FL_KERNELS},
            "phases": {k: {"device_ms": us / 1e3, "launches": n_}
                       for k, (us, n_) in sorted(ranges.items())},
            "peak_bytes_over_held": torch.cuda.max_memory_allocated() - base,
            "top": [(name[:90], us / 1e3) for name, us in ranked[:top]],
            "num_selected": float(info["num_selected"])}


def main_population(args, card: str) -> int:
    r = profile_population(args.population, args.top)
    r["card"] = card
    c = r["config"]
    print(f"one warm make_population_round on {card}: {c}")
    print(f"  wall {r['round_wall_ms']:.1f} ms (the warm-up round "
          f"{r['warm_round_s']:.2f} s); device: kernels "
          f"{r['kernel_device_ms']:.2f} ms, copies {r['copy_device_ms']:.2f}"
          f" ms, busy {r['busy_share']:.1%}; {r['kernel_launches']} kernel "
          f"launches of {r['distinct_kernels']} kernels; FL kernels "
          f"{r['fl_kernel_launches']}; peak "
          f"{r['peak_bytes_over_held'] / 1e6:.1f} MB over the params")
    for name, ph in r["phases"].items():
        print(f"  {name}: {ph['device_ms']:9.3f} ms device, "
              f"{ph['device_ms'] / r['kernel_device_ms']:.2%} of the kernels' "
              f"time, {ph['launches']} launches")
    for name, ms in r["top"]:
        print(f"    {ms:9.3f} ms  {name}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(r, indent=1))
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds-warm", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None)
    ap.add_argument("--grid", action="store_true",
                    help="profile a warm round of the batched grid engine")
    ap.add_argument("--seeds", type=int, default=5,
                    help="seeds of the --grid run (7 cases x 3 strategies "
                         "x seeds trials)")
    ap.add_argument("--aggregation", default="fedavg",
                    help="aggregation family of the --grid run")
    ap.add_argument("--attack", action="store_true",
                    help="run the --grid round under chip_smoke.py phase "
                         "14's adversary")
    ap.add_argument("--population", type=int, default=None,
                    help="profile a warm make_population_round at this "
                         "many clients")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = str(ROOT / "build" / (
            "fl_population_profile.json" if args.population
            else "fl_grid_profile.json" if args.grid else "fl_profile.json"))
    import torch
    if not torch.cuda.is_available():
        print("torch_fl_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.population:
        return main_population(args, card)
    if args.grid:
        return main_grid(args, card)
    r = profile_round(args.rounds_warm, args.top)
    r["card"] = card
    c = r["config"]
    print(f"one warm run_fl_host round on {card}: {c['num_clients']} clients, "
          f"{c['clients_per_round']} a round, {c['local_epochs']} local "
          f"epochs of batch {c['batch_size']}, {c['optimizer']}, "
          f"{c['case']}, {c['strategy']}, {c['aggregation']}")
    print(f"  wall {r['round_wall_ms']:.1f} ms (the loop's own "
          f"{r['round_loop_wall_ms']:.1f} ms); device: kernels "
          f"{r['kernel_device_ms']:.2f} ms, copies {r['copy_device_ms']:.2f}"
          f" ms, busy {r['busy_share']:.1%}; {r['kernel_launches']} kernel "
          f"launches of {r['distinct_kernels']} kernels")
    for name, ph in r["ranges"].items():
        print(f"  {name}: {ph['device_ms']:.3f} ms device, "
              f"{ph['device_ms'] / r['kernel_device_ms']:.2%} of the kernels' "
              f"time, {ph['launches']} launches")
    for name, ms in r["top"]:
        print(f"    {ms:9.3f} ms  {name}")
    for short, f in r["fl_kernels"].items():
        print(f"  {short}: {f['launches']} launch(es), {f['device_ms'] * 1e3:.2f}"
              f" us, {f['share_of_device']:.4%} of the device time, "
              f"{f['share_of_wall']:.5%} of the wall time")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(r, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
