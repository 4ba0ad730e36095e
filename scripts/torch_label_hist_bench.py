#!/usr/bin/env python3
"""Time one checkout's ``label_hist`` kernel on one GPU at phase 7's shapes.

    python3 scripts/torch_label_hist_bench.py [--src DIR] [--out FILE]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and times
its ``label_hist_kernel`` with ``chip_smoke.label_hist_times``: the launch
floor (``torch.cuda._sleep(0)``), the FL round's shape (B=100, n=290, C=10,
round 0 of the paper's case1b plan), and the grid, many-classes and
long-row shapes cold over rotating copies, each beside its bound.  Two
commits compare in one call: unpack the other one with ``git archive`` into
a directory that ``.gitignore`` lists and run this script on both in turns
(other, this, this, other).

Where the checkout's wrapper launches a given plan (``_launch_plan``), the
round's shape is also timed under other plans: 1, 2 or 4 rows a block of one
warp a row, and 2, 4 or 8 warps a row; and the grid's shape, cold, with 8 or
4 rows a block of one warp and 4 of two warps; each plan first held
bit-equal to the plain version.

Needs a CUDA device; prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "label_hist_bench.json"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_label_hist_bench: no CUDA device is available",
              file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.configs import FLConfig
    from repro_torch.kernels.label_hist import label_hist as wrapper
    from repro_torch.kernels.label_hist import label_hist_ref

    dev = torch.device("cuda")
    images, labels, valid = chip_smoke.paper_round_inputs(np, FLConfig(), 0)
    val = torch.from_numpy(valid).to(dev)
    lab0 = torch.where(val, torch.from_numpy(labels).to(dev), 0)
    times = chip_smoke.label_hist_times(
        dev, wrapper.label_hist_kernel, (lab0, val, 10))
    res = {"card": chip_smoke.gpu_name_and_power(), "src": str(src),
           "label_hist": times}
    chip_smoke.say(f"{src} on {res['card']}")
    chip_smoke.say_label_hist_times(times)
    if hasattr(wrapper, "_launch_plan"):
        rows, n = lab0.shape
        want = label_hist_ref(lab0, val, 10)
        res["main_by_plan"] = []
        for rpb, team in ((1, 32), (2, 32), (4, 32), (1, 64), (1, 128),
                          (1, 256)):
            p = wrapper.HistPlan(
                rows_per_block=rpb, team_threads=team, chunks_per_row=1,
                chunk=n, blocks=-(-rows // rpb),
                smem_bytes=wrapper._smem_bytes(rpb, team, 10))
            if not torch.equal(wrapper._launch_plan(lab0, val, 10, p), want):
                raise AssertionError(f"label_hist differs with {p}")
            ms = chip_smoke.time_ms(
                lambda: wrapper._launch_plan(lab0, val, 10, p))
            res["main_by_plan"].append({**dataclasses.asdict(p), "ms": ms})
            chip_smoke.say(f"label_hist at the round's shape, {rpb} rows a "
                           f"block of {team} threads a row ({p.blocks} "
                           f"blocks): {ms:.4f} ms")
        b, n, c = chip_smoke.HIST_GRID
        copies = [chip_smoke.hist_inputs(dev, b, n, c, seed=i) + (c,)
                  for i in range(9)]
        want = label_hist_ref(*copies[0][:2], c)
        res["grid_by_plan"] = []
        for rpb, team in ((8, 32), (4, 32), (4, 64)):
            p = wrapper.HistPlan(
                rows_per_block=rpb, team_threads=team, chunks_per_row=1,
                chunk=n, blocks=-(-b // rpb),
                smem_bytes=wrapper._smem_bytes(rpb, team, 10))
            if not torch.equal(wrapper._launch_plan(*copies[0], p), want):
                raise AssertionError(f"label_hist differs with {p}")
            ms = chip_smoke.time_cold_ms(
                lambda lab, val, c: wrapper._launch_plan(lab, val, c, p),
                copies)
            res["grid_by_plan"].append({**dataclasses.asdict(p), "ms": ms})
            chip_smoke.say(f"label_hist at the grid's shape, cold, {rpb} "
                           f"rows a block of {team} threads a row "
                           f"({p.blocks} blocks): {ms:.4f} ms")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
