#!/usr/bin/env python3
"""Where the SSD backward kernels' time goes, on one GPU, in one call.

    python3 scripts/torch_ssd_bwd_variants.py [--out FILE]

First the checkout's kernels (``csrc/ssd_scan_bwd.cu``) at mamba2-1.3b's
(4, 1024, 64, 64, 1, 128) and jamba-v0.1-52b's (4, 1024, 128, 64, 1, 16)
shapes: the whole call (``chip_smoke.time_ms``) and each of its three
device kernels (``torch.profiler``, the median of ten calls).  Then
variants of the source with one part of ``ssd_bwd_chunk_kernel`` cut out
(``VARIANTS``: its per-chunk loads, the decay matrix, the decay gradients'
sums), or every product of both walking kernels (``nomm``), each compiled
by ``nvcc`` with the build's flags into a library of its own and timed the
same way, the checkout first and last.  A variant's results are wrong by
design: what it removes is the time the part costs, not a design to keep.

Needs a CUDA device; prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"mamba2-1.3b": (4, 1024, 64, 64, 1, 128),
          "jamba-v0.1-52b": (4, 1024, 128, 64, 1, 16)}
CHUNK_KERNEL = "ssd_bwd_chunk_kernel(const float*"

# name -> (first line cut, first line kept after the cut), both inside
# ssd_bwd_chunk_kernel; "nomm" makes block_mm skip every strip instead.
VARIANTS = {
    "noload": ("    load_rows(Xs, LDP, xb + t0 * HP, HP, Q, PS, tv, prow);",
               "    if (tid < Q) dts[tid]"),
    "nodecay_matrix": ("    // L[t][s] = e^(sum over (s, t] of dA), taken",
                       "    __syncthreads();\n    // The intra-chunk dx"),
    "nodecay_sums": ("    float t1 = 0.f, col = 0.f;",
                     "    // G = dec G + (gy o e^cum)^T . C"),
    "nomm": None,
}


def variant_source(src: str, name: str) -> str:
    if name == "nomm":
        loop = "  for (int st = warp; st < strips; st += WARPS) {"
        if src.count(loop) != 1:
            raise ValueError("block_mm's strip loop not found once")
        return src.replace(loop, "  for (int st = strips; st < strips; "
                                 "st += WARPS) {")
    first, kept = VARIANTS[name]
    start = src.index(CHUNK_KERNEL)
    i = src.index(first, start)
    return src[:i] + src[src.index(kept, i):]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "ssd_bwd_variants.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import backward as bwd_mod

    libs = {"checkout": build.library()}
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    out_dir = ROOT / "build" / "ssd_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in VARIANTS:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, name))
        so = out_dir / f"{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [build.cuda_tool(), *build.FLAGS, "-shared", str(cu), "-o",
             str(so)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for name, (so, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}{out}")
        lib = ctypes.CDLL(str(so))
        for fn in ("repro_ssd_scan_bwd", "repro_ssd_scan_bwd_scratch_bytes"):
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = build.RESTYPES.get(fn, ctypes.c_int)
        libs[name] = lib

    dev = torch.device("cuda")
    report = {"card": cs.gpu_name_and_power(), "ms": {}, "kernels_us": {}}
    for arch, (b, s, h, p, g, n) in SHAPES.items():
        x, dt, A, B, C = cs._ssd_inputs(dev, b, s, h, p, g, n, seed=17)
        operands = (x, dt, A.expand(b, h).contiguous(), B, C,
                    torch.randn_like(x), torch.randn((b, h, p, n),
                                                     device=dev))

        def call():
            return bwd_mod.launch_backward(*operands)

        # The checkout's three kernels, by the profiler.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        by_kernel = {}
        for ev in prof.events():
            if ev.device_type.name == "CUDA" and "ssd_bwd" in ev.name:
                key = ev.name.split("ssd_bwd_")[1].split("_kernel")[0]
                by_kernel.setdefault(key, []).append(ev.device_time_total)
        report["kernels_us"][arch] = {k: statistics.median(v)
                                      for k, v in by_kernel.items()}
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            bwd_mod.library = lambda lib=libs[name]: lib
            times[name].append(cs.time_ms(call, reps=5, trials=7))
        bwd_mod.library = build.library
        report["ms"][arch] = times
        cs.say(f"{arch} {(b, s, h, p, g, n)}: the checkout's kernels "
               + ", ".join(f"{k} {v:.1f} us" for k, v in
                           report["kernels_us"][arch].items()))
        for name, t in times.items():
            cs.say(f"{arch}: {name} {', '.join(f'{x:.4f}' for x in t)} ms")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
