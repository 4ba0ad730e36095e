"""The train step on one card: microbatch gradient accumulation in float32,
``clip_by_global_norm(1.0)`` and ``adamw(3e-4)``, as the reference's
``repro/launch/steps.py:make_train_step`` builds it.

The reference returns a function for ``jax.jit`` with its mesh shardings;
the port runs eagerly on one card, so there is no mesh, no sharding rule and
no ``jit``.  Its prefill and serve steps wait for the tooling slice (ROADMAP
Queue 1 item 15); ``launch.serve.run_serve`` serves today.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.shapes import InputShape
from ..models import init_model, loss_fn
from ..models.config import ModelConfig
from ..models.transformer import flatten_params, unflatten_params
from ..optim import (OptState, Optimizer, adamw, apply_updates,
                     clip_by_global_norm)

Params = Dict[str, Any]


@functools.lru_cache(maxsize=None)
def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``'s model, from its shapes alone (the init runs on
    the ``meta`` device, which allocates and draws nothing)."""
    params = flatten_params(init_model(None, cfg, device="meta"))
    return sum(math.prod(p.shape) for p in params.values())


def opt_state_dtype(cfg: ModelConfig) -> torch.dtype:
    """bfloat16 moments above 10 B parameters (so that the optimizer state of
    the largest configs fits), float32 otherwise."""
    return torch.bfloat16 if param_count(cfg) > 10e9 else torch.float32


def default_microbatches(cfg: ModelConfig, shape: InputShape) -> int:
    """Gradient-accumulation depth: about 128k live tokens a microbatch
    (64k above 50 B parameters), a divisor of the global batch."""
    if shape.kind != "train":
        return 1
    tokens = shape.global_batch * shape.seq_len
    target = 131_072 if param_count(cfg) < 5e10 else 65_536
    mb = max(1, tokens // target)
    while shape.global_batch % mb:
        mb -= 1
    return mb


def make_train_step(cfg: ModelConfig, shape: InputShape,
                    microbatches: "int | None" = None
                    ) -> Tuple[Callable, Optimizer]:
    """-> (train_step, opt): ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "grad_norm"})`` over the nested LM params
    and a batch of ``tokens``/``targets`` (B, S), and the AdamW whose
    ``opt.init(flatten_params(params))`` makes its state (moments in
    :func:`opt_state_dtype`).  With ``mb`` microbatches the batch splits
    into ``mb`` equal parts along B; their gradients are summed in float32
    and divided by ``mb``, their losses averaged."""
    mb = microbatches or default_microbatches(cfg, shape)
    opt = adamw(3e-4, state_dtype=opt_state_dtype(cfg))

    def grad_fn(flat: Params, mbatch: Dict[str, torch.Tensor]):
        # Plain autograd, not torch.func.grad: the latter differentiates
        # with create_graph=True, which keeps the backward's intermediates
        # alive and about doubles a full-width step's activation memory.
        leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
        loss = loss_fn(unflatten_params(leaves), cfg, mbatch)[0]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, grads)), loss.detach()

    def train_step(params: Params, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]):
        flat = flatten_params(params)
        if mb > 1:
            parts = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                     for k, v in batch.items()}
            acc = {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in flat.items()}
            losses = []
            for i in range(mb):
                g, loss = grad_fn(flat, {k: v[i] for k, v in parts.items()})
                acc = {k: acc[k] + g[k].to(torch.float32) for k in acc}
                losses.append(loss)
            grads = {k: a / mb for k, a in acc.items()}
            loss = torch.stack(losses).mean()
        else:
            grads, loss = grad_fn(flat, batch)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        ups, opt_state = opt.update(grads, opt_state, flat)
        new = apply_updates(flat, ups)
        return (unflatten_params(new), opt_state,
                {"loss": loss, "grad_norm": gnorm})

    return train_step, opt
