#!/usr/bin/env python3
"""The dry-run's train-step verdicts with and without activation
rematerialisation: each step traced over fake tensors under its config's
remat (``full`` in every published config that stacks more than one
superblock) and again with ``remat=False``, one trace a process.

    python3 scripts/torch_remat_dryrun.py [--jobs N] [--out FILE]
        [--only NAME ...]

The pairs (``CASES``): ``train_4k`` at its default microbatches for the
archs whose bf16 weights and AdamW moments fit one card and whose config
rematerialises (mamba2-1.3b, granite-moe-1b-a400m, minitron-4b,
phi-3-vision-4.2b), and the train steps that ``chip_smoke.py`` phase 22
runs at batch 4 x 4096 and phase 16f at 4 x 1024 in one microbatch
(mamba2-1.3b at full depth, qwen3-14b cut to 4 layers).  The CLI
(``python -m repro_torch.launch.dryrun``) has no switch for remat off, as
the reference's has none; this script sets ``remat=False`` on the config.
Each record is ``launch.dryrun``'s (roofline, peak, kernel nodes, trace
seconds) with ``case`` and ``remat`` added; the lines go to ``--out`` as
JSON, and a table of the peaks and ``useful_flops_fraction`` to stdout.
A full-width trace takes minutes of one core and gigabytes of host
memory: run it where there are both.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (arch, shape name or (seq, batch), num_layers or None,
#          microbatches or None for the default)
CASES = {
    **{f"{arch} train_4k": (arch, "train_4k", None, None)
       for arch in ("mamba2-1.3b", "granite-moe-1b-a400m", "minitron-4b",
                    "phi-3-vision-4.2b")},
    "mamba2-1.3b 4x4096": ("mamba2-1.3b", (4096, 4), None, 1),
    "qwen3-14b 4 layers 4x4096": ("qwen3-14b", (4096, 4), 4, 1),
    "mamba2-1.3b 4x1024": ("mamba2-1.3b", (1024, 4), None, 1),
    "qwen3-14b 4 layers 4x1024": ("qwen3-14b", (1024, 4), 4, 1),
}


def trace(name: str, remat: bool) -> dict:
    """One case's record, traced in this process."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import config_for_shape
    arch, shape, layers, mb = CASES[name]
    shape = (SHAPES[shape] if isinstance(shape, str)
             else InputShape("remat_dryrun", shape[0], shape[1], "train"))
    cfg = config_for_shape(get_config(arch), shape)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if not remat:
        cfg = dataclasses.replace(cfg, remat=False)
    record = dryrun.dryrun_step(arch, cfg, shape, mb)
    record.update(case=name, batch=shape.global_batch, seq=shape.seq_len,
                  num_layers=cfg.num_layers)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "remat_dryrun.jsonl"))
    ap.add_argument("--only", nargs="*", choices=list(CASES), default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        filter(None, (str(ROOT / "src"), os.environ.get("PYTHONPATH"))))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    jobs = [(name, remat) for name in (args.only or CASES)
            for remat in (True, False)]
    t0 = time.time()
    records, failed = [], []
    with ProcessPoolExecutor(max_workers=args.jobs) as pool, \
            open(args.out, "w") as out:
        futures = {pool.submit(trace, *job): job for job in jobs}
        for fut in as_completed(futures):
            name, remat = futures[fut]
            try:
                rec = fut.result()
            except Exception as exc:          # noqa: BLE001 - reported
                failed.append((name, remat, repr(exc)))
                print(f"FAILED {name} remat={remat}: {exc!r}", flush=True)
                continue
            records.append(rec)
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(f"[{time.time() - t0:.0f} s] {name} remat="
                  f"{rec['remat'] and rec['remat_policy']}: peak "
                  f"{rec['peak_memory_per_device'] / 1e9:.2f} GB, "
                  f"fits_one_card={rec['fits_one_card']}, "
                  f"useful_flops_fraction "
                  f"{rec['useful_flops_fraction']:.4f}, traced in "
                  f"{rec['trace_s']:.1f} s ({rec['nodes']} nodes), kernel "
                  f"nodes { {k: v for k, v in rec['kernel_launches'].items() if v} }",
                  flush=True)
    print("\n| case | microbatches | remat | peak (GB) | fits one card | "
          "useful_flops_fraction | trace (s) |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for rec in sorted(records, key=lambda r: (r["case"], not r["remat"])):
        print(f"| {rec['case']} | {rec['microbatches']} | "
              f"{rec['remat_policy'] if rec['remat'] else 'off'} | "
              f"{rec['peak_memory_per_device'] / 1e9:.2f} | "
              f"{rec['fits_one_card']} | "
              f"{rec['useful_flops_fraction']:.4f} | "
              f"{rec['trace_s']:.1f} |")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
