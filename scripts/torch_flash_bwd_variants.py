#!/usr/bin/env python3
"""Time the bf16 flash-attention backward kernels against variants of their
own source on one GPU, in one call.

    python3 scripts/torch_flash_bwd_variants.py [--out FILE]

Each variant is ``csrc/flash_attention.cu`` with one design choice of the
backward undone (``VARIANTS``): P's exponential by the accurate ``exp2f``
instead of ``ex2.approx``, P and dS split with a rounded high half
(``split_p``, as the forward splits P) instead of a truncated one, and a
K/V (dQ) or Q/dO (dK/dV) ring of 2 or 4 stages instead of 3 (``BwdLayout``;
the forward's ring is left as it is).  Every
variant is compiled by ``nvcc`` with the build's flags into a library of
its own (its ``-Xptxas -v`` spills of the backward kernels printed), held
to the plain backward within ``chip_smoke.BWD_TOL`` at three shapes, and
timed with ``chip_smoke.time_ms`` at qwen3-14b's (4, 1024, 40/8, 128)
causal, the checkout's own kernels first and last and the variants in
between, then in reverse order.

Needs a CUDA device; prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import cu_variants

ROOT = Path(__file__).resolve().parents[1]

# name -> (text in csrc/flash_attention.cu, its replacement, where: "bwd"
# replaces it only in the backward's kernels, "all" everywhere).
VARIANTS = {
    "exp2f": ("fast_exp2(sc[j] * scale_log2 - l2(j))",
              "exp2f(sc[j] * scale_log2 - l2(j))", "all"),
    "rounded_split": ("split_trunc(", "split_p(", "bwd"),
    "stages2": ("static constexpr int kStages = D > 128 ? 2 : 3;",
                "static constexpr int kStages = 2;", "all"),
    "stages4": ("static constexpr int kStages = D > 128 ? 2 : 3;",
                "static constexpr int kStages = D > 128 ? 2 : 4;", "all"),
}
BWD_START = "// (q) dQ: one block a (b, h, 128-row q-tile)"
CHECKS = [(2, 77, 8, 1, 64, True, 0), (1, 257, 4, 2, 128, False, 33),
          (1, 333, 10, 2, 128, True, 40)]


def variant_source(src: str, old: str, new: str, where: str) -> str:
    if where == "all":
        return cu_variants.patched(src, [(old, new)])
    head, tail = src.split(BWD_START, 1)
    return head + BWD_START + cu_variants.patched(tail, [(old, new)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "flash_bwd_variants.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     FlashAttentionBackward,
                                                     gqa_attention_bwd_ref)
    from repro_torch.kernels.flash_attention import backward as bwd_mod
    from repro_torch.kernels.flash_attention import flash_attention as fwd_mod

    kernel = r"(flash_bwd_\w+_wgmma)ILi(\d+)"
    libs = {"checkout": build.library()}
    report = {"card": cs.gpu_name_and_power(), "spills": {
        "checkout": cu_variants.resources(
            Path(str(build.build()) + ".log").read_text(), kernel)}}
    src = (build.CSRC / "flash_attention.cu").read_text()
    built = cu_variants.build_variants(
        build, {name: variant_source(src, *v)
                for name, v in VARIANTS.items()},
        ROOT / "build" / "flash_bwd_variants", "repro_flash_attention")
    for name, (lib, log) in built.items():
        libs[name] = lib
        report["spills"][name] = cu_variants.resources(log, kernel)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)

    def inputs(b, s, h, kv, d, causal, window):
        q = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, s, kv, d), generator=g, device=dev)
                .bfloat16() for _ in range(2))
        do = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
        o, lse = FlashAttention.apply(q, k, v, causal, window, True)
        return (q, k, v, o, lse, do)

    checks = [(c, inputs(*c)) for c in CHECKS]
    plain = [gqa_attention_bwd_ref(*(a[i] for i in (0, 1, 2, 3, 5)), *c[5:])
             for c, a in checks]
    big = inputs(4, 1024, 40, 8, 128, True, 0)
    report["gaps"], times = {}, {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name]
        bwd_mod.library = fwd_mod.library = lambda lib=lib: lib
        if name not in report["gaps"]:
            gaps = []
            for (c, operands), want in zip(checks, plain):
                got = FlashAttentionBackward.apply(*operands, *c[5:])
                gaps.append(max(cs._rel(a, w) for a, w in zip(got, want)))
            report["gaps"][name] = gaps
            if max(gaps) > cs.BWD_TOL["bfloat16"]:
                raise AssertionError(f"variant {name}: gaps {gaps}")
        times[name].append(cs.time_ms(
            lambda: FlashAttentionBackward.apply(*big, True, 0), reps=5,
            trials=7))
    bwd_mod.library = fwd_mod.library = build.library
    report["ms"] = times
    for name, t in times.items():
        cs.say(f"{name}: {', '.join(f'{x * 1e3:.1f}' for x in t)} us at "
               f"(4, 1024, 40/8, 128) bf16 causal; spills "
               f"{report['spills'][name]}; gaps to the plain backward "
               f"{', '.join(f'{x:.2e}' for x in report['gaps'][name])}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
