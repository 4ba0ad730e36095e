#!/usr/bin/env python3
"""Train an arch on one GPU with the attention kernels and again with the
plain attention in their place, from the same weights and batches, and
print both trajectories of (loss, grad norm) a step.

    python3 scripts/torch_train_plain_attention.py [--arch A] [--layers N]
        [--steps N] [--batch B] [--seq S] [--full-steps N] [--out FILE]

Both runs are ``run_train``'s recipe (``launch.steps.make_train_step``:
AdamW 3e-4, clip 1.0, bf16 weights from ``PRNGKey(0)``, step i's batch
from ``fold_in(PRNGKey(0), i)``) at full width, cut to ``--layers`` layers
so that the plain attention's (B, H, S, S) scores fit the card.  The plain
run sends every attention layer through ``gqa_attention_ref`` (float32
scores, autograd's backward), the kernels' run through
``gqa_flash_attention`` (the flash forward and backward kernels).  With
``--full-steps`` the kernels' run is repeated at full depth for that many
steps.  It tells a loss curve that the kernels bend from one the recipe
makes.  Needs a CUDA device; prints one JSON object and writes it to
``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def trajectory(arch: str, layers: int, steps: int, batch: int, seq: int,
               plain: bool) -> list:
    import torch
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import TokenDataset, modality_inputs
    from repro_torch.kernels.flash_attention import gqa_attention_ref
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import synth_lm_batch
    from repro_torch.models import init_model, layers as L
    from repro_torch.models.transformer import flatten_params
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    kernel = L.gqa_flash_attention
    if plain:
        L.gqa_flash_attention = (lambda q, k, v, causal=True, window=0:
                                 gqa_attention_ref(q, k, v, causal, window))
    try:
        step, opt = make_train_step(cfg, InputShape("c", seq, batch, "train"),
                                    1)
        dev = torch.device("cuda")
        ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=seq, device=dev)
        key = rng.PRNGKey(0, dev)
        params = init_model(key, cfg, device=dev)
        state = opt.init(flatten_params(params))
        out = []
        for i in range(steps):
            kb = rng.fold_in(key, i)
            b = {**synth_lm_batch(ds, kb, batch),
                 **modality_inputs(cfg, kb, batch)}
            params, state, m = step(params, state, b)
            out.append([float(m["loss"]), float(m["grad_norm"])])
        del params, state
        torch.cuda.empty_cache()
        return out
    finally:
        L.gqa_flash_attention = kernel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi-3-vision-4.2b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--full-steps", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "train_plain_attention.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    cut = (args.arch, args.layers, args.steps, args.batch, args.seq)
    report = {"card": cs.gpu_name_and_power(), "arch": args.arch,
              "layers": args.layers, "batch": args.batch, "seq": args.seq,
              "kernels": trajectory(*cut, plain=False),
              "plain": trajectory(*cut, plain=True)}
    report["max_loss_gap"] = max(abs(a[0] - b[0]) for a, b in
                                 zip(report["kernels"], report["plain"]))
    if args.full_steps:
        report["full_depth_kernels"] = trajectory(
            args.arch, 0, args.full_steps, args.batch, args.seq, plain=False)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
