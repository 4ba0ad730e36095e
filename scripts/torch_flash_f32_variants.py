#!/usr/bin/env python3
"""Hold the float32 flash-attention kernels and variants of their own
source to float64 and time them on one GPU, in one call.

    python3 scripts/torch_flash_f32_variants.py [--out FILE]

Each variant is ``csrc/flash_attention.cu`` with a few lines replaced
(``scripts/cu_variants.py``): in ``VARIANTS``, design constants of
``F32Tiles`` (``kG`` and ``kOutSteps``, the k-steps that go into one
partial of a contraction over D and of an output product; ``kDqResident``,
whether the dQ kernel keeps its resident operand's fragments split in
registers or splits them from its rows at every tile); in ``CUTS``, a part
of the backward's per-tile work cut out (the images, P's exponential, the
output products), which times that part (the cut variants' results are
wrong, and their errors are printed as they come).  Every variant is
compiled by ``nvcc`` with the build's flags into a library of its own (the
float32 kernels' registers and spills printed), its forward and backward
held to a float64 plain version at ``CHECKS`` (each gradient's max |diff|
over its max |value|, the forward's max |diff| / (1 + |o|)), the backward
also to the float32 plain backward on the card, and both timed
with ``chip_smoke.time_ms`` at qwen3-14b's (4, 1024, 40/8, 128) and the lm
round's (960, 64, 4/2, 64) causal shapes, the checkout's own kernels first
and last.

Needs a CUDA device; prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import cu_variants

ROOT = Path(__file__).resolve().parents[1]

# name -> (text, replacement) pairs in csrc/flash_attention.cu: F32Tiles
# constants set otherwise.
VARIANTS = {
    "partials_of_4_steps": [
        ("static constexpr int kG = 2;", "static constexpr int kG = 4;"),
        ("static constexpr int kOutSteps = 2;",
         "static constexpr int kOutSteps = 4;")],
    "partials_of_1_step": [
        ("static constexpr int kG = 2;", "static constexpr int kG = 1;"),
        ("static constexpr int kOutSteps = 2;",
         "static constexpr int kOutSteps = 1;")],
    "dq_streamed": [("static constexpr bool kDqResident = D <= 128;",
                     "static constexpr bool kDqResident = false;")],
}
CUTS = {
    "dq_without_images": [
        ("    image_rows<BK, D>(ks, k_hi, k_lo, tid, 256);\n"
         "    image_rows<BK, D>(vs, v_hi, v_lo, tid, 256);\n"
         "    image_cols<BK, D>(ks, kt_hi, kt_lo, tid, 256);\n", "")],
    "dkv_without_images": [
        ("    image_rows<BQ, D>(qs, q_hi, q_lo, tid, 256);\n"
         "    image_rows<BQ, D>(dos, do_hi, do_lo, tid, 256);\n"
         "    image_cols<BQ, D>(qs, qt_hi, qt_lo, tid, 256);\n"
         "    image_cols<BQ, D>(dos, dot_hi, dot_lo, tid, 256);\n", "")],
    "without_exp": [
        ("        x[j] = ok ? expf(x[j] * scale - stat[(j >> 1) & 1]) : 0.f;",
         "        x[j] = ok ? x[j] * scale - stat[(j >> 1) & 1] : 0.f;"),
        ("        x[j] = ok ? expf(x[j] * scale - lt[i]) : 0.f;",
         "        x[j] = ok ? x[j] * scale - lt[i] : 0.f;")],
    "without_output_products": [
        ("    mma_frag_a_partial<D / 2, BK / 8, KtImg, T::kOutSteps>(",
         "    if (q0 < 0) mma_frag_a_partial<D / 2, BK / 8, KtImg, "
         "T::kOutSteps>("),
        ("    mma_frag_a_partial<D, BQ / 8, QtImg, T::kOutSteps>(",
         "    if (k0 < 0) mma_frag_a_partial<D, BQ / 8, QtImg, T::kOutSteps>(")],
}
# (B, S, H, KV, causal, window) at every float32 head_dim.
CHECKS = [(2, 130, 10, 2, True, 0), (1, 333, 8, 8, False, 33),
          (2, 77, 16, 2, True, 9), (1, 130, 4, 2, False, 0)]
HEAD_DIMS = (16, 32, 64, 96, 128, 192)
TIMED = [(4, 1024, 40, 8, 128), (960, 64, 4, 2, 64)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "flash_f32_variants.json"))
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
                                                     gqa_attention_bwd_ref,
                                                     gqa_attention_ref)
    fwd_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    bwd_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.backward")

    kernel = r"(flash_\w+_tf32)ILi(\d+)"
    libs = {"checkout": build.library()}
    report = {"card": cs.gpu_name_and_power(), "registers": {
        "checkout": cu_variants.resources(
            Path(str(build.build()) + ".log").read_text(), kernel)}}
    src = (build.CSRC / "flash_attention.cu").read_text()
    built = cu_variants.build_variants(
        build, {name: cu_variants.patched(src, pairs)
                for name, pairs in (VARIANTS | CUTS).items()},
        ROOT / "build" / "flash_f32_variants", "repro_flash_attention")
    for name, (lib, log) in built.items():
        libs[name] = lib
        report["registers"][name] = cu_variants.resources(log, kernel)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)

    def inputs(b, s, h, kv, d):
        q = torch.randn((b, s, h, d), generator=g, device=dev)
        k, v = (torch.randn((b, s, kv, d), generator=g, device=dev)
                for _ in range(2))
        return q, k, v, torch.randn((b, s, h, d), generator=g, device=dev)

    checks = []
    for d in HEAD_DIMS:
        for b, s, h, kv, causal, window in CHECKS:
            q, k, v, do = inputs(b, s, h, kv, d)
            o64 = gqa_attention_ref(q.double(), k.double(), v.double(),
                                    causal, window)
            g64 = gqa_attention_bwd_ref(q.double(), k.double(), v.double(),
                                        o64, do.double(), causal, window)
            checks.append(((b, s, h, kv, d, causal, window),
                           (q, k, v, do), o64, g64))
    timed = [(shape, inputs(*shape)) for shape in TIMED]
    report["errors"], times = {}, {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name]
        bwd_mod.library = fwd_mod.library = lambda lib=lib: lib
        if name not in report["errors"]:
            rows = []
            for what, (q, k, v, do), o64, g64 in checks:
                o, lse = FlashAttention.apply(q, k, v, *what[5:], True)
                grads = FlashAttentionBackward.apply(q, k, v, o, lse, do,
                                                     *what[5:])
                again = FlashAttentionBackward.apply(q, k, v, o, lse, do,
                                                     *what[5:])
                fwd = ((o.double() - o64).abs() / (1 + o64.abs())).max()
                plain = gqa_attention_bwd_ref(q, k, v, o, do, *what[5:])
                rows.append({"case": list(what), "fwd": fwd.item(),
                             "vs_plain": max(cs._rel(x, w) for x, w in
                                             zip(grads, plain)),
                             **{n: cs._rel(x, w) for n, x, w in
                                zip(("dq", "dk", "dv"), grads, g64)},
                             "repeat_equal": all(
                                 torch.equal(x, y)
                                 for x, y in zip(grads, again))})
            report["errors"][name] = rows
        row = []
        for shape, (q, k, v, do) in timed:
            o, lse = FlashAttention.apply(q, k, v, True, 0, True)
            def bwd():
                return FlashAttentionBackward.apply(q, k, v, o, lse, do,
                                                    True, 0)
            row.append({"shape": list(shape),
                        "fwd_ms": cs.time_ms(lambda: FlashAttention.apply(
                            q, k, v, True, 0, True), reps=5, trials=7),
                        "bwd_ms": cs.time_ms(bwd, reps=5, trials=7),
                        "bwd_kernels_us": cs.kernel_times_us(bwd)})
        times[name].append(row)
    bwd_mod.library = fwd_mod.library = build.library
    report["ms"] = times
    for name, t in times.items():
        errs = report["errors"][name]
        worst = {key: max(r[key] for r in errs)
                 for key in ("fwd", "dq", "dk", "dv", "vs_plain")}
        cs.say(f"{name}: worst against float64 {worst} (limits "
               f"{cs.FLASH_F32_TOL:.0e} and {cs.BWD_TOL['float32']:.1e}), "
               f"repeats bit-equal {all(r['repeat_equal'] for r in errs)}")
        for d in HEAD_DIMS:
            cs.say(f"  D={d}: " + "; ".join(
                f"{tuple(r['case'][:4])} c={r['case'][5]} w={r['case'][6]} "
                f"fwd {r['fwd']:.1e} dq {r['dq']:.1e} dk {r['dk']:.1e} "
                f"dv {r['dv']:.1e} (vs plain {r['vs_plain']:.1e})"
                for r in errs if r["case"][4] == d))
        for i, shape in enumerate(TIMED):
            cs.say(f"  {shape}: forward "
                   f"{', '.join(f'{r[i]["fwd_ms"]:.4f}' for r in t)} ms, "
                   f"backward "
                   f"{', '.join(f'{r[i]['bwd_ms']:.4f}' for r in t)} ms")
        cs.say(f"  registers {report['registers'][name]}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
