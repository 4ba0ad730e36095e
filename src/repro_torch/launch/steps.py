"""Step builders of the launchers and the dry-run, as the reference's
``repro/launch/steps.py`` builds them: the train step (microbatch gradient
accumulation in float32, ``clip_by_global_norm(1.0)``, ``adamw(3e-4)``), the
prefill step (the prompt -> argmax tokens and the caches) and the serve step
(one token against resident caches).

The reference returns a function for ``jax.jit`` with its mesh shardings;
the port runs eagerly on one card, so there is no mesh, no sharding and no
``jit``.  ``make_prefill_step`` and ``make_serve_step`` return the step and
its abstract arguments (``meta``-device tensors from ``data.specs``), which
``launch.dryrun`` traces; on real tensors the steps launch the kernels.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..configs.shapes import InputShape
from ..data.specs import input_specs
from ..models import decode_step, init_model, loss_fn, prefill
from ..models.config import ModelConfig
from ..models.transformer import flatten_params, unflatten_params
from ..optim import (OptState, Optimizer, adamw, apply_updates,
                     clip_by_global_norm)

Params = Dict[str, Any]


def abstract_params(cfg: ModelConfig) -> Params:
    """``cfg``'s nested params on the ``meta`` device: shapes and dtypes,
    nothing allocated or drawn."""
    return init_model(None, cfg, device="meta")


@functools.lru_cache(maxsize=None)
def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``'s model, from :func:`abstract_params`."""
    params = flatten_params(abstract_params(cfg))
    return sum(math.prod(p.shape) for p in params.values())


def opt_state_dtype(cfg: ModelConfig) -> torch.dtype:
    """bfloat16 moments above 10 B parameters (so that the optimizer state of
    the largest configs fits), float32 otherwise."""
    return torch.bfloat16 if param_count(cfg) > 10e9 else torch.float32


def abstract_opt_state(cfg: ModelConfig, params: Params) -> OptState:
    """The train step's AdamW state for ``params`` on the ``meta`` device:
    moments in :func:`opt_state_dtype` over the flat params, step 0."""
    dt = opt_state_dtype(cfg)
    moments = {k: torch.empty(p.shape, dtype=dt, device="meta")
               for k, p in flatten_params(params).items()}
    return OptState(step=0, mu=moments, nu=dict(moments))


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
    and divided by ``mb``, their losses averaged.

    The step writes the new params and moments into the tensors it is given,
    a leaf at a time, and returns them: it consumes its arguments.  The
    reference's functional step leaves the buffers to XLA; built anew here,
    a full-width step would hold the old and new params and moments and the
    whole tree's float32 updates at once (83 GB by the dry-run at
    phi-3-vision-4.2b's 3.7 B params with float32 moments).  The arithmetic
    is the optimizer's, leaf by leaf, so the values are the same bits."""
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
        for k, p in flat.items():
            mu, nu = opt_state.mu[k], opt_state.nu[k]
            ups, one = opt.update({k: grads.pop(k)},
                                  OptState(opt_state.step, {k: mu}, {k: nu}),
                                  {k: p})
            p.copy_(apply_updates({k: p}, ups)[k])
            mu.copy_(one.mu[k])
            nu.copy_(one.nu[k])
        opt_state = OptState(opt_state.step + 1, opt_state.mu, opt_state.nu)
        return (unflatten_params(flat), opt_state,
                {"loss": loss, "grad_norm": gnorm})

    return train_step, opt


def make_prefill_step(cfg: ModelConfig, shape: InputShape
                      ) -> Tuple[Callable, Tuple[Any, ...]]:
    """-> (prefill_step, (params, batch) as ``meta`` tensors):
    ``prefill_step(params, batch) -> (tokens, caches)``, the int32 argmax of
    the last position's logits (B,) and the caches of ``shape.seq_len``
    that ``prefill`` fills (one ``flash_attention`` or ``ssd_scan`` launch a
    layer on the card).  Runs without autograd."""
    batch_specs, _ = input_specs(cfg, shape)

    def prefill_step(params: Params, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            logits, caches = prefill(params, cfg, batch,
                                     max_len=shape.seq_len)
            return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return prefill_step, (abstract_params(cfg), batch_specs)


def make_serve_step(cfg: ModelConfig, shape: InputShape
                    ) -> Tuple[Callable, Tuple[Any, ...]]:
    """-> (serve_step, (params, tokens, caches) as ``meta`` tensors): ONE
    new token against caches of ``shape.seq_len``.  ``serve_step(params,
    tokens, caches) -> (next_tokens, caches)``, int32 (B,) argmax tokens;
    the caches are updated in place (``decode_step``), and no kernel
    launches (decode is plain PyTorch, as the reference computes it).  The
    reference's ``kv_policy`` picks the caches' mesh sharding; one card
    places nothing, so it lives only in ``sharding.make_rules``."""
    specs, _ = input_specs(cfg, shape)

    def serve_step(params: Params, tokens: torch.Tensor,
                   caches: List[Dict[str, Any]]):
        with torch.no_grad():
            logits, new_caches = decode_step(params, cfg, tokens, caches)
            return torch.argmax(logits, dim=-1).to(torch.int32), new_caches

    return serve_step, (abstract_params(cfg), specs["tokens"],
                        specs["caches"])


def arch_shape_applicable(cfg: ModelConfig, shape: InputShape
                          ) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention: SSM and hybrid archs run
    natively, pure attention archs run the sliding-window variant."""
    if shape.name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid"):
        return True, "sliding_window=4096 variant (sub-quadratic carve-in)"
    return True, ""


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """``cfg`` with ``sliding_window=4096`` at long_500k for attention
    archs, as :func:`arch_shape_applicable` notes; else ``cfg``."""
    if shape.name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid"):
        return dataclasses.replace(cfg, sliding_window=4096)
    return cfg
