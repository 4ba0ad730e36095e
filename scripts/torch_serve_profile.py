#!/usr/bin/env python3
"""Where the time of the port's serving path goes on one GPU.

    python3 scripts/torch_serve_profile.py [--arch qwen3-14b mamba2-1.3b]
                                           [--out build/serve_profile.json]
    python3 scripts/torch_serve_profile.py --arch phi-3-vision-4.2b whisper-tiny

For each arch at full width (random weights from seed 0, as ``run_serve``
draws them, and its stub patch or frame embeddings; batch 4, prompt 1024,
the shapes ``chip_smoke.py`` serves; whisper-tiny batch 16, prompt 448, as
phase 21 serves it):

* prefill: warm wall time (two calls first, then one timed call), and one
  call under ``torch.profiler`` — device time by kernel, device busy share;
* decode: warm wall time per token over 10 steps, and one step under the
  profiler — device time, host time, kernel launches.

The encoder-decoder's parts are profiler ranges, whose device time is
that of the kernels launched inside them: ``encoder`` (``encode_audio``),
``cross_kv`` (``encode_cross_kv``, the decoder layers' K/V of the encoder
output) and ``cross_attention`` (``cross_attention_apply``, plain PyTorch).

Needs a CUDA device; prints a summary and writes the numbers as JSON.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _sync():
    import torch
    torch.cuda.synchronize()


# Profiler ranges around the encoder-decoder's parts (see the note).
RANGES = {"encoder": ("transformer", "encode_audio"),
          "cross_kv": ("layers", "encode_cross_kv"),
          "cross_attention": ("layers", "cross_attention_apply")}
# (batch, prompt) a served arch takes; the rest take (4, 1024).
SERVE_SHAPE = {"whisper-tiny": (16, 448)}


def _ranged(fn, name: str):
    from torch.profiler import record_function

    def wrapped(*args, **kw):
        with record_function(name):
            return fn(*args, **kw)
    return wrapped


def _profile(fn, top: int = 8) -> dict:
    """Device time by kernel name, device total and host wall time of one
    ``fn()`` under torch.profiler, and the device time inside each of
    ``RANGES``."""
    from torch.profiler import ProfilerActivity, profile
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall = time.perf_counter() - t0
    kernels, ranges = {}, {}
    launches = 0
    for ev in prof.events():
        if ev.name in RANGES:
            # The range's host event carries its kernels' device time; its
            # device-side copy (the span on the card's timeline) is left
            # out of the kernel totals.
            if ev.device_type.name != "CUDA":
                ranges[ev.name] = (ranges.get(ev.name, 0.0)
                                   + ev.device_time_total / 1e3)
        elif ev.device_type.name == "CUDA":
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time_total
        elif ev.name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += 1
    device_us = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
            "busy_share": device_us / 1e3 / (wall * 1e3),
            "launches": launches, "ranges_ms": ranges,
            "top": [(name[:80], us / 1e3) for name, us in ranked]}


def profile_arch(arch: str) -> dict:
    import torch
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, modality_inputs
    from repro_torch.models import decode_step, init_model, prefill

    dev = torch.device("cuda")
    cfg = get_config(arch)
    params = init_model(rng.PRNGKey(0, dev), cfg, device=dev)
    batch, prompt_len = SERVE_SHAPE.get(arch, (4, 1024))
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                      device=dev)
    key = rng.PRNGKey(0, dev)
    inputs = {"tokens": ds.sample(key, torch.arange(batch, device=dev)
                                  % ds.num_domains),
              **modality_inputs(cfg, key, batch)}
    prompts = inputs["tokens"]
    patches = cfg.num_patch_tokens if cfg.arch_type == "vlm" else 0
    res = {"arch": arch, "batch": batch, "prompt_len": prompt_len}
    with torch.inference_mode():
        run = lambda: prefill(params, cfg, inputs,          # noqa: E731
                              prompt_len + 16 + patches)
        for _ in range(2):
            run()
        _sync()
        t0 = time.perf_counter()
        _, caches = run()
        _sync()
        res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        res["prefill_profile"] = _profile(run)

        toks = prompts[:, -1]
        _, caches = run()
        for _ in range(3):
            decode_step(params, cfg, toks, caches)
        _sync()
        t0 = time.perf_counter()
        for _ in range(10):
            decode_step(params, cfg, toks, caches)
        _sync()
        res["decode_ms_per_token"] = (time.perf_counter() - t0) / 10 * 1e3
        res["decode_profile"] = _profile(
            lambda: decode_step(params, cfg, toks, caches))
        del caches

    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["qwen3-14b", "mamba2-1.3b"])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "serve_profile.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.models import layers, transformer
    modules = {"layers": layers, "transformer": transformer}
    for name, (module, attr) in RANGES.items():
        setattr(modules[module], attr,
                _ranged(getattr(modules[module], attr), name))
    results = {"card": card, "archs": [profile_arch(a) for a in args.arch]}
    for r in results["archs"]:
        pp, dp = r["prefill_profile"], r["decode_profile"]
        print(f"{r['arch']} (batch {r['batch']}, prompt {r['prompt_len']}) "
              f"on {card}")
        print(f"  prefill {r['prefill_ms']:.1f} ms warm; profiled: wall "
              f"{pp['wall_ms']:.1f} ms, device {pp['device_ms']:.1f} ms "
              f"(busy {pp['busy_share']:.1%}), {pp['launches']} launches")
        for name, ms in pp["ranges_ms"].items():
            print(f"    {ms:9.3f} ms  in the range {name!r} "
                  f"({ms / pp['device_ms']:.1%} of the device time)")
        for name, ms in pp["top"]:
            print(f"    {ms:9.3f} ms  {name}")
        print(f"  decode {r['decode_ms_per_token']:.2f} ms/token warm; "
              f"profiled: wall {dp['wall_ms']:.1f} ms, device "
              f"{dp['device_ms']:.2f} ms (busy {dp['busy_share']:.1%}), "
              f"{dp['launches']} launches")
        for name, ms in dp["ranges_ms"].items():
            print(f"    {ms:9.3f} ms  in the range {name!r} "
                  f"({ms / dp['device_ms']:.1%} of the device time)")
        for name, ms in dp["top"]:
            print(f"    {ms:9.3f} ms  {name}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
