"""Client-side local training (paper Eq. 2, Algorithm 1 lines 17–24), batched
over the selected clients.

Parameters and batches carry a leading client axis; one step computes every
client's gradient at once with ``torch.func.vmap(grad(...))``, so only the
selected clients ever compute.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.func import grad_and_value, vmap

from ..optim import apply_updates

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _batch(batches: Batch, b: int) -> Batch:
    """Minibatch ``b`` of every client: leaves (S, n_batches, bs, ...) ->
    (S, bs, ...)."""
    return {k: v[:, b] for k, v in batches.items()}


def local_train(params: Params, opt, batches: Batch, loss_fn: LossFn,
                local_epochs: int) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """``local_epochs`` epochs of minibatch descent for S clients at once.

    params: leaves (S, ...), one model per client; batches: leaves
    (S, n_batches, batch_size, ...).  Returns the trained (S, ...) models and
    {"loss": (S,) mean minibatch loss of the last epoch}."""
    step = vmap(grad_and_value(loss_fn, has_aux=True))
    state = opt.init(params)
    n_batches = next(iter(batches.values())).shape[1]
    epoch_loss = None
    for _ in range(local_epochs):
        losses = []
        for b in range(n_batches):
            grads, (loss, _) = step(params, _batch(batches, b))
            ups, state = opt.update(grads, state, params)
            params = apply_updates(params, ups)
            losses.append(loss)
        epoch_loss = torch.stack(losses).mean(0)
    return params, {"loss": epoch_loss}


def local_gradient(params: Params, batches: Batch, loss_fn: LossFn
                   ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """FedSGD clients: each reports the mean of its minibatch gradients at its
    own params (leaves (S, ...), as for :func:`local_train`).  Returns
    (S, ...) gradients and {"loss": (S,) mean minibatch loss}."""
    step = vmap(grad_and_value(loss_fn, has_aux=True))
    n_batches = next(iter(batches.values())).shape[1]
    acc, losses = None, []
    for b in range(n_batches):
        grads, (loss, _) = step(params, _batch(batches, b))
        grads = {k: g.to(torch.float32) for k, g in grads.items()}
        acc = grads if acc is None else {k: acc[k] + grads[k] for k in acc}
        losses.append(loss)
    return ({k: a / n_batches for k, a in acc.items()},
            {"loss": torch.stack(losses).mean(0)})


def batched_eval(eval_fn: LossFn) -> LossFn:
    """``eval_fn(params, batch)`` over a leading model axis of ``params``
    (the grid's trials, or a clustered family's models), one batch shared:
    ``vmap(eval_fn, in_dims=(0, None))``."""
    return vmap(eval_fn, in_dims=(0, None))
