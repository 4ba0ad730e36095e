#!/usr/bin/env python3
"""Where the time of one FL round of the port goes on one GPU.

    python3 scripts/torch_fl_profile.py [--rounds-warm 2] [--top 12]
                                        [--out build/fl_profile.json]

Runs ``run_fl_host`` at the paper's width (``configs.FLConfig()``: 100
clients, 30 a round, 4 local epochs of batch 32, Adam; case1b, labelwise,
fedavg) on the card: first ``--rounds-warm`` rounds to warm it up (the
kernel build, cuDNN's algorithm choice, the allocator), then one round under
``torch.profiler``.  Prints the round's wall time, the device time and busy
share, the kernel launches, the device time by kernel, and the shares of
the port's two FL kernels, ``label_hist`` and ``weighted_agg``.

Needs a CUDA device; writes the numbers as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
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
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.configs import FLConfig
    from repro_torch.core import case_label_plan
    from repro_torch.data import ImageDataset
    from repro_torch.fl import run_fl_host

    dev = torch.device("cuda")
    cfg = FLConfig()
    plan = case_label_plan("case1b", 0, rounds_warm + 1, cfg.num_clients)
    ds = ImageDataset(device=dev)
    kw = dict(strategy="labelwise", aggregation="fedavg", ds=ds, device=dev)
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
    device, launches, copies_us = {}, 0, 0.0
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            if ev.name.startswith(("Memcpy", "Memset")):
                copies_us += ev.device_time_total
            else:
                device[ev.name] = device.get(ev.name, 0.0) + \
                    ev.device_time_total
        elif ev.name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += 1
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
            "top": [(name[:90], us / 1e3) for name, us in ranked[:top]],
            "accuracy": hist.accuracy, "num_selected": hist.num_selected}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds-warm", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=str(ROOT / "build" / "fl_profile.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_fl_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
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
