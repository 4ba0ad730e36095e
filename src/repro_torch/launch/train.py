"""Training launcher: ``steps`` train steps of an ``--arch`` config on
synthetic token batches, on one card (or the CPU), or on every rank of a
process group: one card a rank under NCCL, or CPU processes under gloo.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --reduced --steps 20 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-14b --reduced --steps 20 --batch 8 --seq 128 \\
        [--device cpu]

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

As the reference's ``run_train`` trains on ``make_debug_mesh()``, a run
whose default process group is initialised (``main`` initialises it under
``torchrun``) trains on the debug mesh: data parallelism with the weights'
``EMBED`` rows split over the ranks where ``cfg.fsdp`` (or ``fsdp=``) is
on.  Each rank draws its weights a leaf at a time and keeps its blocks,
draws only its rows of each step's batch (bit-equal to those rows of the
whole draw), and rank 0 writes the checkpoint from the gathered params,
the same file as the one-card run's.  Rank r runs on ``cuda:{LOCAL_RANK}``
under NCCL, or on the CPU under gloo with ``device="cpu"``; any other
pairing, or a failing collective, is an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .. import rng
from ..ckpt import save_checkpoint
from ..configs import ARCH_IDS, get_config
from ..configs.shapes import InputShape
from ..data import TokenDataset, modality_inputs
from ..device import resolve_device
from ..models import init_model
from ..models.transformer import flatten_params, unflatten_params
from .mesh import make_debug_mesh
from .steps import batch_rows, make_train_step, param_layout


def synth_lm_batch(ds: TokenDataset, key, batch: int,
                   domains: Optional[torch.Tensor] = None,
                   rows: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """``batch`` sequences under ``key``: domains by ``randint(key, (batch,),
    0, D)`` unless given, tokens ``ds.sample(key, domains)``, targets the
    tokens rolled left with −1 last.  With ``rows`` only those rows are
    drawn, bit-equal to the whole batch's rows."""
    if domains is None:
        domains = rng.randint(key, (batch,), 0, ds.num_domains)
    if rows is None:
        toks = ds.sample(key, domains)
    else:
        toks = ds.sample(key, domains[:, None], rows)[:, 0]
    targets = torch.roll(toks, -1, dims=1)
    targets[:, -1] = -1
    return {"tokens": toks, "targets": targets}


def _rank_device(device: "str | torch.device | None") -> torch.device:
    """A rank's device: ``cuda:{LOCAL_RANK}`` under NCCL, the CPU under
    gloo; the caller's ``device`` must name the same type."""
    cuda = dist.get_backend() == "nccl"
    asked = torch.device("cuda" if device is None else device)
    if (asked.type == "cuda") != cuda:
        raise RuntimeError(f"device {asked} under the "
                           f"{dist.get_backend()} backend: a rank trains on "
                           f"its card under nccl, or on the CPU under gloo")
    if not cuda:
        return asked
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    resolve_device(dev)
    torch.cuda.set_device(dev)
    return dev


def run_train(arch: str, steps: int, batch: int, seq: int, reduced: bool,
              ckpt_dir: Optional[str] = None, log_every: int = 10,
              device: "str | torch.device | None" = None,
              num_layers: Optional[int] = None,
              step_times: Optional[List[float]] = None, *,
              fsdp: Optional[bool] = None,
              record: Optional[dict] = None) -> List[float]:
    """Train ``steps`` steps and return each step's loss.  ``reduced`` takes
    the config's smoke variant with a 512-token vocabulary; ``num_layers``
    cuts the depth (the port's addition, see the module note).  A
    ``step_times`` list receives each step's wall seconds, the device
    synchronised at both ends.  ``ckpt_dir`` receives the final params
    (the port's nested tree) at step ``steps``.

    With an initialised default process group every rank calls this, on
    the debug mesh (see the module note); ``fsdp`` overrides
    ``cfg.fsdp``.  A ``record`` dict receives each step's ``grad_norms``
    and the final ``params`` and ``opt_state`` (a rank's blocks on a
    mesh)."""
    mesh = None
    if dist.is_available() and dist.is_initialized():
        device = _rank_device(device)
        mesh = make_debug_mesh()
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(vocab_size=512)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    step_fn, opt = make_train_step(
        cfg, InputShape("custom", seq, batch, "train"), microbatches=1,
        mesh=mesh, fsdp=fsdp)
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=seq, device=device)
    key = rng.PRNGKey(0, device)
    layout = rows = None
    if mesh is not None:
        layout = param_layout(cfg, mesh, fsdp)
        rows = batch_rows(batch, 1, layout.rank, layout.size, device)
    params = init_model(key, cfg, device=device, layout=layout)
    opt_state = opt.init(flatten_params(params))
    lead = layout is None or layout.rank == 0
    losses: List[float] = []
    norms: List[float] = []
    t0 = time.perf_counter()
    for i in range(steps):
        t_step = time.perf_counter()
        kb = rng.fold_in(key, i)
        b = {**synth_lm_batch(ds, kb, batch, rows=rows),
             **modality_inputs(cfg, kb, batch, rows=rows)}
        params, opt_state, m = step_fn(params, opt_state, b)
        losses.append(float(m["loss"]))          # synchronises the device
        norms.append(float(m["grad_norm"]))
        if step_times is not None:
            step_times.append(time.perf_counter() - t_step)
        if lead and i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
    if ckpt_dir:
        # On a mesh every rank takes part in each leaf's gather, a leaf at
        # a time, and rank 0 keeps the whole leaves on the host.
        whole = {}
        for k, x in flatten_params(params).items():
            if layout is not None:
                x = layout.gather_leaf(k, x)
                x = x.cpu() if lead else None
            whole[k] = x
        if lead:
            save_checkpoint(ckpt_dir, steps, unflatten_params(whole),
                            {"arch": arch, "loss": losses[-1]})
    if record is not None:
        record.update(grad_norms=norms, params=params, opt_state=opt_state)
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
    ap.add_argument("--fsdp", dest="fsdp", action="store_true", default=None,
                    help="split the weights' EMBED rows over the ranks "
                         "(default: the config's fsdp)")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    args = ap.parse_args(argv)
    ranked = int(os.environ.get("WORLD_SIZE", "1")) > 1 \
        and not dist.is_initialized()
    if ranked:      # under torchrun: its env:// rendezvous
        dist.init_process_group(
            "gloo" if torch.device(args.device or "cuda").type == "cpu"
            else "nccl")
    try:
        losses = run_train(args.arch, args.steps, args.batch, args.seq,
                           args.reduced, args.ckpt_dir, device=args.device,
                           num_layers=args.num_layers, fsdp=args.fsdp)
        lead = not dist.is_initialized() or dist.get_rank() == 0
    finally:
        if ranked:
            dist.destroy_process_group()
    if lead:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return 0 if all(math.isfinite(x) for x in losses) else 1


if __name__ == "__main__":
    sys.exit(main())
