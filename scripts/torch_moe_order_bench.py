#!/usr/bin/env python3
"""The MoE capacity path's sums on one GPU: this checkout's ``moe_apply``
against another checkout's, at granite-moe-1b-a400m's training shape.

    python3 scripts/torch_moe_order_bench.py [--src DIR] [--reps N]
        [--step-reps N] [--out FILE]

Both ``moe_apply`` functions run in this process: this checkout's, and the
one in ``DIR/src/repro_torch/models/layers.py`` (a ``git archive`` of
another commit under a directory that ``.gitignore`` lists), loaded as a
module of this checkout's ``repro_torch.models`` package, so that only the
layer's own code differs.  At the layer shape of granite-moe-1b-a400m's
train step (4 x 1024 tokens, 32 experts, top 8, d 1024, bf16, capacity
routing; weights from ``moe_init`` at PRNGKey(0), x and the loss weight
from NumPy), each version runs its forward and backward three times:
whether the output, the aux loss and every gradient are bit-equal run to
run (the largest gap of the float32 reading of a leaf over its max
magnitude where not), and how far the two versions' results lie apart.
Then the forward and the forward + backward are timed in turns (other,
this, this, other; ``--reps`` calls a turn, CUDA events, the median a
call), beside the card's name and power limit.

Then the whole model: granite-moe-1b-a400m at full width and depth, one
train step's gradients at 4 x 1024 under its config's remat
(``launch.steps.make_grad_step`` on ``run_train``'s first batch, weights
from PRNGKey(0)) with each version as the blocks' ``moe_apply``: whether
two steps' loss and gradients are bit-equal, and the step timed in turns
(other, this, this, other; ``--step-reps`` steps a turn, wall time with
the card synchronised, the median a step).

Needs a CUDA device; prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 1024


def load_layers(path: Path):
    """``path`` (a ``models/layers.py``) as a module of this checkout's
    ``repro_torch.models`` package."""
    mod = types.ModuleType("repro_torch.models._other_layers")
    mod.__package__ = "repro_torch.models"
    mod.__file__ = str(path)
    exec(compile(path.read_text(), str(path), "exec"), mod.__dict__)
    return mod


def run(moe_apply, cfg, p, x, w):
    """(y, aux, grads of sum(y·w) + 3·aux in x and every leaf)."""
    import torch
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    xx = x.detach().requires_grad_()
    y, aux = moe_apply(leaves, xx, cfg)
    grads = torch.autograd.grad((y.float() * w).sum() + 3.0 * aux,
                                [xx] + list(leaves.values()))
    return [y.detach(), aux.detach()] + list(grads)


def gap(a, b) -> float:
    return max((u.float() - v.float()).abs().max().item()
               / max(v.float().abs().max().item(), 1e-30)
               for u, v in zip(a, b))


def time_ms(fn, reps: int) -> float:
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def step(versions: dict, reps: int) -> dict:
    """granite-moe-1b-a400m's gradient step with each version of
    ``moe_apply`` in the blocks: run-to-run bit-equality and wall seconds
    a step in turns."""
    import gc
    import time
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import init_model, layers
    from repro_torch.rng import PRNGKey
    dev = torch.device("cuda")
    cfg = get_config("granite-moe-1b-a400m")
    params = init_model(PRNGKey(0, dev), cfg, device=dev)
    batch = chip_smoke._remat_batch(dev, cfg, S)
    grad_step = make_grad_step(cfg)
    own = layers.moe_apply
    out = {}

    def one():
        grads, loss = grad_step(params, batch)
        torch.cuda.synchronize()
        return grads, loss

    try:
        for name, fn in versions.items():
            layers.moe_apply = fn
            g1, l1 = one()
            g2, l2 = one()
            out[f"{name}_step_bit_equal"] = torch.equal(l1, l2) and all(
                torch.equal(g1[k], g2[k]) for k in g1)
            out[f"{name}_step_run_gap"] = max(
                (g1[k].float() - g2[k].float()).abs().max().item()
                / max(g2[k].float().abs().max().item(), 1e-30) for k in g1)
            del g1, g2
            gc.collect()
        walls = {n: [] for n in versions}
        for name in ("other", "this", "this", "other"):
            layers.moe_apply = versions[name]
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                one()
                times.append(time.perf_counter() - t0)
            walls[name].append(statistics.median(times))
        out["step_s"] = walls
    finally:
        layers.moe_apply = own
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--step-reps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "moe_order_bench.json"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_order_bench: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.models.layers import moe_init

    dev = torch.device("cuda")
    cfg = get_config("granite-moe-1b-a400m")
    p = {k: v.to(dev) for k, v in moe_init(rng.PRNGKey(0), cfg).items()}
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal((B, S, cfg.d_model)).astype(
        np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(g.standard_normal((B, S, cfg.d_model)).astype(
        np.float32)).to(dev)
    other = load_layers(Path(args.src).resolve() / "src" / "repro_torch"
                        / "models" / "layers.py")
    versions = {"this": layers.moe_apply, "other": other.moe_apply}
    res = {"card": chip_smoke.gpu_name_and_power(), "src": args.src,
           "shape": [B * S, cfg.num_experts, cfg.experts_per_token,
                     cfg.d_model, cfg.dtype]}
    first = {}
    for name, fn in versions.items():
        outs = [run(fn, cfg, p, x, w) for _ in range(3)]
        first[name] = outs[0]
        res[f"{name}_bit_equal_run_to_run"] = all(
            torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o))
        res[f"{name}_run_gap"] = max(gap(o, outs[0]) for o in outs[1:])
        del outs
    res["this_against_other"] = gap(first["this"], first["other"])
    del first
    fwd = {n: [] for n in versions}
    both = {n: [] for n in versions}
    for name in ("other", "this", "this", "other"):
        fn = versions[name]
        with torch.no_grad():
            fwd[name].append(time_ms(lambda: fn(p, x, cfg), args.reps))
        both[name].append(time_ms(lambda: run(fn, cfg, p, x, w), args.reps))
    res["forward_ms"] = fwd
    res["forward_backward_ms"] = both
    res.update(step(versions, args.step_reps))
    chip_smoke.say(json.dumps(res))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
