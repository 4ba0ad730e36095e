"""Optimizers over ``dict[str, Tensor]`` parameters: sgd and adam, with the
reference's arithmetic (``repro.optim.optimizers``), not ``torch.optim``'s.

    opt = adam(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Adam's update is ``u = −η·(m/bc1)/(sqrt(v/bc2)+eps)`` with the bias
corrections ``bc = 1 − β^step`` taken in float32 from the step counter.  The
tensors may carry a leading client axis: every op is elementwise, so a stack
of clients that share the step counter updates as one.
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


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    eta = float(np.float32(lr))

    def init(params):
        return OptState(step=0,
                        mu={k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in params.items()},
                        nu={k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in params.items()})

    def update(grads, state, params=None):
        step = state.step + 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        mu, nu, ups = {}, {}, {}
        for k, g in grads.items():
            gf = g.to(torch.float32)
            mf = b1 * state.mu[k] + (1 - b1) * gf
            vf = b2 * state.nu[k] + (1 - b2) * gf * gf
            ups[k] = -eta * (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
            mu[k], nu[k] = mf, vf
        return ups, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p.to(torch.float32) + updates[k]).to(p.dtype)
            for k, p in params.items()}


def get_optimizer(name: str, lr: float) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "adam":
        return adam(lr)
    raise KeyError(f"unknown optimizer {name!r}; this slice of the port has "
                   "sgd and adam")
