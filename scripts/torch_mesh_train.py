#!/usr/bin/env python3
"""``run_train`` on the debug mesh across the cards of one machine: data
parallelism with FSDP of the weights' ``EMBED`` rows over the ``data``
axis, one NCCL rank a card.

    python3 scripts/torch_mesh_train.py [--arch qwen3-14b] [--layers N]
        [--world 4] [--steps 3] [--batch 4] [--seq 1024] [--no-fsdp]
        [--out FILE]

Starts ``--world`` processes (``torch.multiprocessing.spawn``, a file
store under ``build/``), rank r on card r, each calling
``launch.train.run_train(arch, steps, batch, seq, reduced=False,
num_layers=layers, fsdp=...)``: weights from PRNGKey(0), a rank's block
of each drawn a leaf at a time, its rows of each step's synthetic batch.
Each rank reports its losses, step times (the card synchronised) and
``max_memory_allocated`` over the whole run (init, draws and steps), and
its weights' and moments' bytes.  Prints one JSON object with every
rank's numbers beside the card's name and power limit and writes it to
``--out``.  Needs ``--world`` CUDA devices.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _rank(rank: int, world: int, args: dict, out: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.train import run_train
        times, rec = [], {}
        losses = run_train(args["arch"], args["steps"], args["batch"],
                           args["seq"], reduced=False,
                           num_layers=args["layers"], step_times=times,
                           log_every=args["steps"], fsdp=args["fsdp"],
                           record=rec)

        def nbytes(tree):
            return sum(t.numel() * t.element_size() for t in tree.values())

        from repro_torch.models.transformer import flatten_params
        Path(out, f"rank{rank}.json").write_text(json.dumps({
            "losses": losses, "grad_norms": rec["grad_norms"],
            "step_s": times, "peak": torch.cuda.max_memory_allocated(dev),
            "param_bytes": nbytes(flatten_params(rec["params"])),
            "moment_bytes": nbytes(rec["opt_state"].mu)
            + nbytes(rec["opt_state"].nu)}))
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if torch.cuda.device_count() < a.world:
        print(f"torch_mesh_train: {a.world} ranks need {a.world} CUDA "
              f"devices; {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    work = ROOT / "build" / "mesh_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    args = {"arch": a.arch, "layers": a.layers, "steps": a.steps,
            "batch": a.batch, "seq": a.seq, "fsdp": a.fsdp}
    mp.spawn(_rank, args=(a.world, args, str(work)), nprocs=a.world)
    result = {"cards": card, "world": a.world, **args,
              "ranks": [json.loads((work / f"rank{r}.json").read_text())
                        for r in range(a.world)]}
    text = json.dumps(result)
    print(text)
    if a.out:
        Path(a.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
