#!/usr/bin/env python3
"""Where the SSD backward kernels' time goes, on one GPU, in one call.

    python3 scripts/torch_ssd_bwd_variants.py [--out FILE]

First the checkout's kernels (``csrc/ssd_scan_bwd.cu``) at mamba2-1.3b's
(4, 1024, 64, 64, 1, 128) and jamba-v0.1-52b's (4, 1024, 128, 64, 1, 16)
shapes: the whole call (``chip_smoke.time_ms``) and each of its six device
kernels (``chip_smoke.ssd_bwd_kernel_times``: ``torch.profiler``, the
median of ten calls, the two walks apart).  Then variants of the source
with one part cut out (``VARIANTS``: the two walks, or in the head-summed
pass its loads, its split into hi and lo planes, its products, its per-head
epilogue, or its head-summed end products), each compiled by ``nvcc`` with
the build's flags into a library of its own and timed the same way, the
checkout first and last.  A variant's results are wrong by design: what it removes is the
time the part costs, not a design to keep.

Needs a CUDA device; prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import cu_variants

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"mamba2-1.3b": (4, 1024, 64, 64, 1, 128),
          "jamba-v0.1-52b": (4, 1024, 128, 64, 1, 16)}

# name -> (text, replacement) pairs in csrc/ssd_scan_bwd.cu.
VARIANTS = {
    "nowalks": [
        ("  int e = two ? launch_walk<NP, 2, false>",
         "  int e = 0;\n  if (0) e = two ? launch_walk<NP, 2, false>"),
        ("  e = two ? launch_walk<NP, 2, true>",
         "  if (0) e = two ? launch_walk<NP, 2, true>")],
    "group_noload": [("    if (nh < h_hi) load_share(nh, nq);\n", "")],
    "group_nosplit": [
        ("    for (int idx = tid; idx < 2 * QP * 8; idx += blockDim.x) {",
         "    for (int idx = tid; idx < 0; idx += blockDim.x) {"),
        ("    for (int idx = tid; idx < NP * 8; idx += blockDim.x) {\n"
         "      const int o = 16 * idx;",
         "    for (int idx = tid; idx < 0; idx += blockDim.x) {\n"
         "      const int o = 16 * idx;")],
    "group_noproducts": [
        ("    for (int kk = 0; kk < 4; ++kk) {\n      const int ko = 32 * kk;",
         "    for (int kk = 0; kk < 0; ++kk) {\n      const int ko = 32 * kk;")],
    "group_noepilogue": [("    if (q + 1 == PQ) {", "    if (false) {")],
    "group_noend": [
        ("  end_product(dCa, false);\n  end_product(dBa, true);\n", "")],
}


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
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import backward as bwd_mod

    libs = {"checkout": build.library()}
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    built = cu_variants.build_variants(
        build, {name: cu_variants.patched(src, pairs)
                for name, pairs in VARIANTS.items()},
        ROOT / "build" / "ssd_bwd_variants", "repro_ssd_scan_bwd")
    libs.update({name: lib for name, (lib, _) in built.items()})

    dev = torch.device("cuda")
    report = {"card": cs.gpu_name_and_power(), "ms": {}, "kernels_us": {}}
    for arch, (b, s, h, p, g, n) in SHAPES.items():
        x, dt, A, B, C = cs._ssd_inputs(dev, b, s, h, p, g, n, seed=17)
        operands = (x, dt, A.expand(b, h).contiguous(), B, C,
                    torch.randn_like(x), torch.randn((b, h, p, n),
                                                     device=dev))

        def call():
            return bwd_mod.launch_backward(*operands)

        report["kernels_us"][arch] = cs.ssd_bwd_kernel_times(call)
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
