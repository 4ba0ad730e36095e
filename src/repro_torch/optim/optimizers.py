"""Optimizers over ``dict[str, Tensor]`` parameters: sgd, momentum, adam
and adamw, and the global-norm clip, with the reference's arithmetic
(``repro.optim.optimizers``), not ``torch.optim``'s.  The learning rate is
a float or a schedule (``optim.schedules``: a function of the step counter
returning a float32 0-dim tensor), read at the step before the update.

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

from typing import Any, Callable, Collection, Dict, NamedTuple, Optional, Tuple

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


Schedule = Callable[[int], torch.Tensor]


def _f32(x: float) -> float:
    return float(np.float32(x))


def _as_schedule(lr: "float | Schedule") -> Schedule:
    """A float rate -> the constant schedule of its float32 value (a
    Python float, which a float32 tensor takes as float32)."""
    if callable(lr):
        return lr
    eta = _f32(lr)
    return lambda step: eta


def sgd(lr: "float | Schedule") -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return OptState(step=0)

    def update(grads, state, params=None):
        eta = sched(state.step)
        ups = {k: -eta * g.to(torch.float32) for k, g in grads.items()}
        return ups, OptState(step=state.step + 1)

    return Optimizer(init, update)


def momentum(lr: "float | Schedule", beta: float = 0.9,
             state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """Heavy ball: ``μ ← β·μ + g`` (float32, stored in ``state_dtype``),
    ``u = −η·μ``."""
    sched = _as_schedule(lr)

    def init(params):
        return OptState(step=0, mu={k: torch.zeros_like(p, dtype=state_dtype)
                                    for k, p in params.items()})

    def update(grads, state, params=None):
        eta = sched(state.step)
        mu = {k: (beta * state.mu[k].to(torch.float32)
                  + g.to(torch.float32)).to(state.mu[k].dtype)
              for k, g in grads.items()}
        ups = {k: -eta * m.to(torch.float32) for k, m in mu.items()}
        return ups, OptState(step=state.step + 1, mu=mu)

    return Optimizer(init, update)


def _adam_core(lr: "float | Schedule", b1: float, b2: float, eps: float,
               weight_decay: float, state_dtype: torch.dtype) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return OptState(step=0,
                        mu={k: torch.zeros_like(p, dtype=state_dtype)
                            for k, p in params.items()},
                        nu={k: torch.zeros_like(p, dtype=state_dtype)
                            for k, p in params.items()})

    def update(grads, state, params=None):
        eta = sched(state.step)
        # −η·wd·θ: the reference rounds η·wd to float32 before the product.
        eta_wd = (_f32(np.float32(eta) * np.float32(weight_decay))
                  if isinstance(eta, float) else eta * weight_decay)
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


def adam(lr: "float | Schedule", b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8,
         state_dtype: torch.dtype = torch.float32) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0, state_dtype)


def adamw(lr: "float | Schedule", b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay, state_dtype)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p.to(torch.float32) + updates[k]).to(p.dtype)
            for k, p in params.items()}


def global_norm(tree: Params, group: Any = None,
                sharded: Collection[str] = ()) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.
    With a process ``group``, the leaves named in ``sharded`` hold one
    rank's block each: their sums are summed over the ranks (one
    all-reduce), and every other leaf, whole on every rank, counts once."""
    sums = {k: torch.sum(torch.square(g.to(torch.float32)))
            for k, g in tree.items()}
    split = [k for k in sums if k in sharded]
    if group is not None and split:
        from ..core.aggregation import all_reduce_sum
        whole = all_reduce_sum(torch.stack([sums[k] for k in split]), group)
        sums.update(zip(split, whole.unbind()))
    return torch.sqrt(sum(sums.values()))


def clip_by_global_norm(grads: Params, max_norm: float, group: Any = None,
                        sharded: Collection[str] = ()
                        ) -> Tuple[Params, torch.Tensor]:
    """Every leaf times ``min(1, max_norm / max(norm, 1e-12))`` (the factor
    cast to the leaf's dtype) -> (clipped, norm); ``group`` and
    ``sharded`` as :func:`global_norm`'s."""
    norm = global_norm(grads, group, sharded)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def get_optimizer(name: str, lr: "float | Schedule",
                  state_dtype: torch.dtype = torch.float32) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, state_dtype=state_dtype)
    if name == "adam":
        return adam(lr, state_dtype=state_dtype)
    if name == "adamw":
        return adamw(lr, state_dtype=state_dtype)
    raise KeyError(f"unknown optimizer {name!r}")
