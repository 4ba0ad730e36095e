"""Training launcher: ``steps`` train steps of an ``--arch`` config on one
card (or the CPU) on synthetic token batches.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --reduced --steps 20 --batch 8 --seq 128 --device cpu

Mirrors ``repro/launch/train.py``: weights from ``init_model(PRNGKey(0))``,
step i's batch from ``fold_in(PRNGKey(0), i)`` (domains by ``randint``,
tokens from ``TokenDataset``; a VLM's ``patch_embeds`` and an
encoder-decoder's ``frames`` from ``data.modality_inputs`` under the same
key), bit-equal to the reference's draws, and the train step of
``launch.steps``.  ``num_layers`` is the port's one addition: a depth cut
for a full-width config whose weights, gradients and optimizer state do
not fit one card; it changes no width.  With ``ckpt_dir`` the
final params are saved there as the reference saves them
(``ckpt/checkpoint.py``: ``ckpt_{steps:08d}.npz``, ``extra`` holding the
arch and the last loss).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from .. import rng
from ..ckpt import save_checkpoint
from ..configs import ARCH_IDS, get_config
from ..configs.shapes import InputShape
from ..data import TokenDataset, modality_inputs
from ..device import resolve_device
from ..models import init_model
from ..models.transformer import flatten_params
from .steps import make_train_step


def synth_lm_batch(ds: TokenDataset, key, batch: int,
                   domains: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """``batch`` sequences under ``key``: domains by ``randint(key, (batch,),
    0, D)`` unless given, tokens ``ds.sample(key, domains)``, targets the
    tokens rolled left with −1 last."""
    if domains is None:
        domains = rng.randint(key, (batch,), 0, ds.num_domains)
    toks = ds.sample(key, domains)
    targets = torch.roll(toks, -1, dims=1)
    targets[:, -1] = -1
    return {"tokens": toks, "targets": targets}


def run_train(arch: str, steps: int, batch: int, seq: int, reduced: bool,
              ckpt_dir: Optional[str] = None, log_every: int = 10,
              device: "str | torch.device | None" = None,
              num_layers: Optional[int] = None,
              step_times: Optional[List[float]] = None) -> List[float]:
    """Train ``steps`` steps and return each step's loss.  ``reduced`` takes
    the config's smoke variant with a 512-token vocabulary; ``num_layers``
    cuts the depth (the port's addition, see the module note).  A
    ``step_times`` list receives each step's wall seconds, the device
    synchronised at both ends.  ``ckpt_dir`` receives the final params
    (the port's nested tree) at step ``steps``."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(vocab_size=512)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    step_fn, opt = make_train_step(cfg, InputShape("custom", seq, batch,
                                                   "train"), microbatches=1)
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=seq, device=device)
    key = rng.PRNGKey(0, device)
    params = init_model(key, cfg, device=device)
    opt_state = opt.init(flatten_params(params))
    losses: List[float] = []
    t0 = time.perf_counter()
    for i in range(steps):
        t_step = time.perf_counter()
        kb = rng.fold_in(key, i)
        b = {**synth_lm_batch(ds, kb, batch),
             **modality_inputs(cfg, kb, batch)}
        params, opt_state, m = step_fn(params, opt_state, b)
        losses.append(float(m["loss"]))          # synchronises the device
        if step_times is not None:
            step_times.append(time.perf_counter() - t_step)
        if i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, params,
                        {"arch": arch, "loss": losses[-1]})
    return losses


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth (full width kept)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    losses = run_train(args.arch, args.steps, args.batch, args.seq,
                       args.reduced, args.ckpt_dir, device=args.device,
                       num_layers=args.num_layers)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return 0 if all(math.isfinite(x) for x in losses) else 1


if __name__ == "__main__":
    sys.exit(main())
