"""Serving launcher: batched prefill, then a greedy decode loop, for an
``--arch`` config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --batch 4 --prompt-len 32 --gen 16 --device cpu

Mirrors ``repro/launch/serve.py``.  Weights are random and prompts come
from ``TokenDataset``, both drawn from ``PRNGKey(0)`` as the reference draws
them, as are a VLM's stub patch embeddings and an encoder-decoder's stub
frame embeddings (``data.modality_inputs``); no checkpoint or tokenizer is
involved.  A VLM's caches hold its patches too.  The CLI keeps the
reference's flags, whose ``--reduced`` is always on; ``run_serve(...,
reduced=False)`` serves the full-width config.  Two arguments are the
port's additions: ``num_layers``, as in ``launch/train.py``, a depth cut
for a full-width config whose weights do not fit one card (it changes no
width); and ``params``, weights already on the device to serve instead of
drawing them, so that a caller that checks other things on the same
full-width weights draws them once.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import torch

from .. import rng
from ..configs import ARCH_IDS, get_config
from ..data import TokenDataset, modality_inputs
from ..device import resolve_device
from ..models import decode_step, init_model, prefill


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_serve(arch: str, batch: int, prompt_len: int, gen: int,
              reduced: bool = True, greedy: bool = True,
              device: "str | torch.device | None" = None,
              num_layers: Optional[int] = None,
              params: Optional[dict] = None):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode greedily
    to ``gen`` tokens each.  Returns (seqs (batch, gen), t_prefill seconds,
    t_decode seconds per token); the card is synchronised before each clock
    reading.  ``greedy`` is kept from the reference, which also only decodes
    greedily; ``num_layers`` cuts the depth and ``params`` (the model's
    weights for the config the other arguments make, on ``device``) takes
    the place of the draw (see the module note)."""
    if not greedy:
        raise NotImplementedError("only greedy decoding is served, as in the "
                                  "reference")
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(vocab_size=512)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    key = rng.PRNGKey(0, device)
    if params is None:
        params = init_model(key, cfg, device=device)
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                      device=device)
    domains = torch.arange(batch, device=device) % ds.num_domains
    inputs = {"tokens": ds.sample(key, domains),
              **modality_inputs(cfg, key, batch)}
    max_len = prompt_len + gen + (cfg.num_patch_tokens
                                  if cfg.arch_type == "vlm" else 0)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = prefill(params, cfg, inputs, max_len)
        toks = torch.argmax(logits, dim=-1)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        out = [toks]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, caches = decode_step(params, cfg, toks, caches)
            toks = torch.argmax(logits, dim=-1)
            out.append(toks)
        _sync(device)
        t_decode = (time.perf_counter() - t0) / max(gen - 1, 1)
    return torch.stack(out, dim=1), t_prefill, t_decode


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth (full width kept)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    seqs, t_p, t_d = run_serve(args.arch, args.batch, args.prompt_len,
                               args.gen, reduced=args.reduced,
                               device=args.device,
                               num_layers=args.num_layers)
    print(f"generated {tuple(seqs.shape)} tokens; prefill {t_p:.2f}s, "
          f"{t_d * 1000:.1f} ms/token decode")
    print("first sequence:", seqs[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
