#!/usr/bin/env python3
"""Hold the sharded engine's gather-reduce to ``host`` and ``sim`` at the
paper's FL width on one GPU, with the engine's own float32 gather and with
the reference's rebuild of the trained params as ``params + delta``.

    python3 scripts/torch_sharded_drift.py [--rounds 3]

The paper's FL setup (``FLConfig()``), case1b x (labelwise, random) x one
seed, under ``median`` and under ``median`` with a quarter of the clients
poisoning (scale -4), TF32 off and cuDNN's deterministic algorithms on.
Each spec runs on ``sim``, ``host``, ``sharded`` and ``sharded`` with the
rebuild put back (``rebuild``: the gathered trained params replaced by
``params + (trained - params)`` in float32, the reference's arithmetic;
one group, so the gather is the identity).  Prints each round's eval loss
a run and each run's largest relative loss gap a round to ``host``, then
one JSON object with the same numbers.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
POISON = {"frac": 0.25, "behaviors": ["poison"], "scale": -4.0}


def rebuild_patch():
    """Make ``fl.sharded``'s gather-reduce see ``params + (trained −
    params)``: the round's global params are read where it builds its
    slots' start models, and its gather of the trained params returns the
    rebuilt ones (one group: the gather itself is the identity)."""
    import torch
    import repro_torch.fl.sharded as sharded
    seen = {}
    start, gather = sharded.start_models, sharded.gather_client_shards

    def start_models(params, *a, **kw):
        seen["params"] = {k: v[0] for k, v in params.items()}
        return start(params, *a, **kw)

    def gather_client_shards(tree, group):
        p = seen["params"]
        return gather({k: p[k].to(torch.float32) + (u.to(torch.float32)
                                                    - p[k].to(torch.float32))
                       for k, u in tree.items()}, group)

    sharded.start_models = start_models
    sharded.gather_client_shards = gather_client_shards

    def undo():
        sharded.start_models, sharded.gather_client_shards = start, gather
    return undo


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_sharded_drift: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import FLConfig
    from repro_torch.data import ImageDataset
    from repro_torch.fl import ExperimentSpec, ScenarioSpec, run
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    ds = ImageDataset(device=dev)
    out = {"card": card, "rounds": args.rounds, "runs": {}}
    for name, adversary in (("median", {}), ("median+poison", POISON)):
        loss = {}
        for run_name in ("sim", "host", "sharded", "rebuild"):
            spec = ExperimentSpec(
                scenarios=(ScenarioSpec.from_case("case1b"),),
                strategies=("labelwise", "random"), seeds=(0,),
                engine="sharded" if run_name == "rebuild" else run_name,
                fl=FLConfig(), rounds=args.rounds, aggregation="median",
                adversary=adversary)
            undo = rebuild_patch() if run_name == "rebuild" else None
            try:
                res = run(spec, ds=ds, device=dev)
            finally:
                if undo is not None:
                    undo()
            loss[run_name] = res.loss.reshape(-1, args.rounds)
            print(f"{name} {run_name}: eval loss "
                  f"{loss[run_name].tolist()}", flush=True)
        gaps = {r: (np.abs(loss[r] - loss["host"])
                    / np.abs(loss["host"])).max(0).tolist()
                for r in ("sim", "sharded", "rebuild")}
        for r, g in gaps.items():
            print(f"{name}: {r} against host, largest relative loss gap a "
                  f"round {[f'{x:.3e}' for x in g]}", flush=True)
        out["runs"][name] = {"loss": {r: v.tolist() for r, v in loss.items()},
                             "gap_to_host": gaps}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
