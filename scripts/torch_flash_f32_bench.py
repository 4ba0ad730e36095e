#!/usr/bin/env python3
"""Time one checkout's float32 flash-attention kernels on one GPU.

    python3 scripts/torch_flash_f32_bench.py [--src DIR] [--out FILE]
                                             [--no-shapes] [--no-round]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and, in
float32 with TF32 off, unless ``--no-shapes``, holds to the plain version
and then times at three causal shapes

* qwen3-14b's prefill, (B, S, H/KV, D) = (4, 1024, 40/8, 128);
* the ``lm`` FL round at the paper's width (fl-lm-12m: 30 clients x 32
  sequences of 64 tokens in one launch), (960, 64, 4/2, 64);
* the registered micro ``lm`` at head_dim 16, at the shape its training
  launches in chip_smoke.py phase 16e (recorded from that run),

the forward as a training step runs it (each row's logsumexp written too)
and the backward pair, each beside its bound (the products once at
495 TFLOP/s TF32, or the bytes at 3.35 TB/s, whichever is larger), the
plain version and ``torch.nn.functional.scaled_dot_product_attention`` in
float32 (``chip_smoke.f32_attention_times``).  Then, unless
``--no-round``, phase 16e's paper-width ``lm`` run (labelwise): the warm
rounds' wall times from a run of 3 rounds, and attention's device time in
one warm round from ``torch.profiler`` traces of runs of 2 and 3 rounds
(every kernel whose name holds ``flash``: the round runs no other
attention), the second's less the first's, and the same of every kernel
(the device's busy time in a warm round).

Two commits compare in one call: unpack the other one with ``git archive``
into a directory that ``.gitignore`` lists and run this script on both in
turns (other, this, this, other).  Needs a CUDA device; prints one JSON
object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import collections
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

QWEN = (4, 1024, 40, 8, 128)
LM_ROUND = (960, 64, 4, 2, 64)


def _record_shapes(fa_mod, bwd_mod):
    """Patch the forward's and backward's launchers to count their calls by
    (direction, B, S, H, KV, D, dtype); returns the counter and an undo."""
    seen = collections.Counter()
    fwd, bwd = fa_mod.launch, bwd_mod.launch_backward

    def launch(q, k, v, **kw):
        seen[("fwd",) + tuple(q.shape[:3]) + (k.shape[2], q.shape[3],
                                               str(q.dtype))] += 1
        return fwd(q, k, v, **kw)

    def launch_backward(q, k, v, *rest, **kw):
        seen[("bwd",) + tuple(q.shape[:3]) + (k.shape[2], q.shape[3],
                                               str(q.dtype))] += 1
        return bwd(q, k, v, *rest, **kw)

    fa_mod.launch, bwd_mod.launch_backward = launch, launch_backward

    def undo():
        fa_mod.launch, bwd_mod.launch_backward = fwd, bwd
    return seen, undo


def time_shape(chip_smoke, dev, shape) -> dict:
    """The float32 forward (with lse) and backward kernels at one causal
    shape, held to the plain version, beside their bounds, plain versions
    and SDPA (``chip_smoke.f32_attention_times``)."""
    out = {"shape": list(shape)}
    for which in ("fwd", "bwd"):
        r = chip_smoke.f32_attention_times(dev, *shape, which=which)
        out.update({f"{which}_{key}": x for key, x in r.items()
                    if key != "shape"})
    return out


def device_time_in_run(run, spec, dev) -> tuple:
    """Device time (ms) and launches of the kernels whose names hold
    ``flash`` in one ``run(spec)``, then of every kernel (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(spec, device=dev)
        torch.cuda.synchronize()
    events = [ev for ev in prof.events() if ev.device_type.name == "CUDA"]
    flash = [ev.device_time_total for ev in events if "flash" in ev.name]
    return (sum(flash) / 1e3, len(flash),
            sum(ev.device_time_total for ev in events) / 1e3, len(events))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "flash_f32_bench.json"))
    ap.add_argument("--no-shapes", action="store_true")
    ap.add_argument("--no-round", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_f32_bench: no CUDA device is available",
              file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.configs import FLConfig
    from repro_torch.fl import lm_workload, register_workload, run
    from repro_torch.models.config import ModelConfig

    dev = torch.device("cuda")
    old = chip_smoke._tf32(False, False)
    res = {"card": chip_smoke.gpu_name_and_power(), "src": str(src)}
    chip_smoke.say(f"{src} on {res['card']}")
    if not args.no_shapes:
        # The micro lm's launch shapes: phase 16e's micro run, recorded.
        fa_mod = importlib.import_module(
            "repro_torch.kernels.flash_attention.flash_attention")
        bwd_mod = importlib.import_module(
            "repro_torch.kernels.flash_attention.backward")
        seen, undo = _record_shapes(fa_mod, bwd_mod)
        micro = chip_smoke._lm_fl_spec(
            np, "sim", 2, workload="lm", domains=10,
            fl=dict(num_clients=6, clients_per_round=3, local_epochs=1,
                    batch_size=4))
        run(micro, device=dev)
        undo()
        train = [key for key in seen if key[0] == "bwd"]
        micro_shape = max(train, key=lambda key: seen[key])[1:6]
        res["micro_launches"] = {str(key): n for key, n in seen.items()}
        chip_smoke.say(f"micro lm launches by shape: {dict(seen)}")
        res["shapes"] = [time_shape(chip_smoke, dev, shape)
                         for shape in (QWEN, LM_ROUND, micro_shape)]
    if not args.no_round:
        register_workload("lm-12m", lm_workload(
            ModelConfig(**chip_smoke.FL_LM_CFG), num_domains=8, seq_len=64),
            overwrite=True)
        cfg = FLConfig()

        def spec(rounds):
            return chip_smoke._lm_fl_spec(
                np, "sim", rounds, strategies=("labelwise",), seqs=32,
                fl=dict(num_clients=cfg.num_clients,
                        clients_per_round=cfg.clients_per_round,
                        local_epochs=cfg.local_epochs,
                        batch_size=cfg.batch_size, lr=cfg.lr))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(spec(3), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        round_s = out.meta["sim"]["round_s"]
        two, three = (device_time_in_run(run, spec(r), dev)
                      for r in (2, 3))
        att_ms, launches, busy_ms, kernels = (y - x
                                              for x, y in zip(two, three))
        warm = sorted(round_s[1:])
        res["lm_round"] = {"round_s": round_s, "run_s": wall,
                           "attention_ms": att_ms, "launches": launches,
                           "busy_ms": busy_ms, "kernels": kernels,
                           "attention_share": att_ms / 1e3 / warm[0],
                           "busy_share": busy_ms / 1e3 / warm[0],
                           "traced": {"2 rounds": two, "3 rounds": three}}
        chip_smoke.say(
            f"paper-width lm (fl-lm-12m, N=100, 30 a round, 4 local epochs "
            f"of batch 32, 32 sequences of 64), 3 rounds: rounds "
            f"{[f'{x:.4f}' for x in round_s]} s wall; a warm round's device "
            f"time (traced 3 rounds less 2): attention {launches} launches, "
            f"{att_ms:.3f} ms ({res['lm_round']['attention_share']:.2%} of "
            f"the faster warm round); every kernel {kernels} launches, "
            f"{busy_ms:.3f} ms ({res['lm_round']['busy_share']:.2%})")
    chip_smoke._tf32(*old)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
