"""Optimizers over ``dict[str, Tensor]`` parameters: sgd, adam and adamw,
and the global-norm clip, with the reference's arithmetic
(``repro.optim.optimizers``), not ``torch.optim``'s.

    opt = adam(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Adam's update is ``u = −η·(m/bc1)/(sqrt(v/bc2)+eps)`` with the bias
corrections ``bc = 1 − β^step`` taken in float32 from the step counter;
AdamW subtracts ``η·wd·θ`` (θ in float32) as well.  The moments are
computed in float32 and stored in ``state_dtype`` (the reference's bf16
moments for the largest configs).  The tensors may carry a leading client
axis: every op is elementwise, so a stack of clients that share the step
counter updates as one.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], "OptState"]
    update: Callable[[Params, "OptState", Optional[Params]],
                     Tuple[Params, "OptState"]]


class OptState(NamedTuple):
    step: int
    mu: Optional[Params] = None
    nu: Optional[Params] = None


def sgd(lr: float) -> Optimizer:
    eta = float(np.float32(lr))

    def init(params):
        return OptState(step=0)

    def update(grads, state, params=None):
        ups = {k: -eta * g.to(torch.float32) for k, g in grads.items()}
        return ups, OptState(step=state.step + 1)

    return Optimizer(init, update)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _adam_core(lr: float, b1: float, b2: float, eps: float,
               weight_decay: float, state_dtype: torch.dtype) -> Optimizer:
    eta = _f32(lr)
    # −η·wd·θ: the reference rounds η·wd to float32 before the product.
    eta_wd = _f32(np.float32(eta) * np.float32(weight_decay))

    def init(params):
        return OptState(step=0,
                        mu={k: torch.zeros_like(p, dtype=state_dtype)
                            for k, p in params.items()},
                        nu={k: torch.zeros_like(p, dtype=state_dtype)
                            for k, p in params.items()})

    def update(grads, state, params=None):
        step = state.step + 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        mu, nu, ups = {}, {}, {}
        for k, g in grads.items():
            gf = g.to(torch.float32)
            m, v = state.mu[k], state.nu[k]
            mf = b1 * m.to(torch.float32) + (1 - b1) * gf
            vf = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
            u = -eta * (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
            if weight_decay and params is not None:
                u = u - eta_wd * params[k].to(torch.float32)
            ups[k] = u
            mu[k], nu[k] = mf.to(m.dtype), vf.to(v.dtype)
        return ups, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0, torch.float32)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay, state_dtype)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p.to(torch.float32) + updates[k]).to(p.dtype)
            for k, p in params.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = sum(torch.sum(torch.square(g.to(torch.float32)))
                for g in tree.values())
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """Every leaf times ``min(1, max_norm / max(norm, 1e-12))`` (the factor
    cast to the leaf's dtype) -> (clipped, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def get_optimizer(name: str, lr: float) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "adam":
        return adam(lr)
    if name == "adamw":
        return adamw(lr)
    raise KeyError(f"unknown optimizer {name!r}; the port has sgd, adam and "
                   "adamw (the reference's momentum is not ported)")
