"""One FL round (paper Algorithm 1) for a single global model.

Per round T:
  1. every client has reported its label histogram (``hists``),
  2. the strategy ranks clients; the server asks ``order[:budget]`` to train,
     with ``budget`` the strategy's static slot count,
  3. only those clients train locally, batched over the client axis,
  4. masked weighted aggregation (FedAvg Eq. 1 with the clients' sample
     counts as weights) through the weighted_agg kernel on a CUDA device,
  5. the server interpolates; an empty selection leaves the params as they
     were (Algorithm 1's count = 0 case).

``aggregation='fedsgd'`` switches clients to one gradient each and the server
to one −lr step.  Steps 3–5 (:func:`client_updates`, :func:`server_update`)
take a leading trial axis: the grid engine (``sim.py``) runs them for every
trial of a grid at once, the host round with one.  Clustered families,
robust reducers and the adversary hooks come with later slices of the port.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core import (Aggregator, get_aggregator, get_strategy, interpolate,
                    selection_budget)
from ..kernels.dispatch import masked_weighted_mean
from ..optim import apply_updates, get_optimizer
from .client import local_gradient, local_train

Params = Dict[str, torch.Tensor]


def resolve_aggregator(agg: "str | Aggregator | None", fl_cfg) -> Aggregator:
    """Name (or None -> ``fl_cfg.aggregation``) -> registered Aggregator."""
    if isinstance(agg, Aggregator):
        return agg
    return get_aggregator(agg or fl_cfg.aggregation)


def client_updates(global_params: Params, data: Dict[str, torch.Tensor],
                   loss_fn, opt, fl_cfg, agg: Aggregator
                   ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """What the selected clients of T models report, trained at once.

    global_params: leaves (T, ...), one global model a trial; data: leaves
    (T·S, n_batches, batch_size, ...), S clients a trial, trial-major.  Each
    client starts from its trial's model and reports its trained params
    (FedAvg) or the mean of its minibatch gradients (FedSGD).  Returns
    (T·S, ...) leaves and {"loss": (T·S,)}."""
    trials = next(iter(global_params.values())).shape[0]
    per = next(iter(data.values())).shape[0] // trials
    start = {k: p[:, None].expand((trials, per) + p.shape[1:])
             .reshape((trials * per,) + p.shape[1:])
             for k, p in global_params.items()}
    if agg.base == "fedsgd":
        return local_gradient(start, data, loss_fn)
    return local_train(start, opt, data, loss_fn, fl_cfg.local_epochs)


def server_update(global_params: Params, updates: Params, live: torch.Tensor,
                  sizes: torch.Tensor, fl_cfg, agg: Aggregator) -> Params:
    """Masked weighted reduction and server step of T models at once.

    global_params: leaves (T, ...); updates: leaves (T, S, ...) from
    :func:`client_updates`; live, sizes: (T, S), the FedAvg weights being
    each client's count of valid samples.  The default reduction is one
    ``masked_weighted_mean`` (one ``weighted_agg`` launch on a card for
    every trial); an override ``agg.reduce`` takes one trial's (S, ...)
    leaves.  A trial with no live client keeps its params (Algorithm 1's
    count = 0 case: the ε-denominator mean would zero them)."""
    if agg.reduce is None:
        red = masked_weighted_mean(updates, live, sizes)
    else:
        outs = [agg.reduce({k: u[i] for k, u in updates.items()}, live[i],
                           sizes[i]) for i in range(live.shape[0])]
        red = {k: torch.stack([o[k] for o in outs]) for k in updates}
    if agg.base == "fedsgd":
        new = apply_updates(global_params,
                            {k: -fl_cfg.lr * g for k, g in red.items()})
    else:
        new = interpolate(global_params, red, fl_cfg.server_lr)
    any_live = live.sum(-1) > 0
    return {k: torch.where(any_live.reshape((-1,) + (1,) * (old.dim() - 1)),
                           new[k], old) for k, old in global_params.items()}


def client_update_step(global_params: Params, data_sel: Dict[str, torch.Tensor],
                       live: torch.Tensor, loss_fn, opt, fl_cfg,
                       agg_kind: "str | Aggregator"
                       ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """Local training, masked aggregation and server update for the selected
    clients of one global model: :func:`client_updates` and
    :func:`server_update` with one trial.  data_sel: leaves (S, n_batches,
    batch_size, ...); live: (S,) 0/1.  Returns (new global params,
    per-client metrics)."""
    agg = resolve_aggregator(agg_kind, fl_cfg)
    if agg.clustered:
        raise ValueError("client_update_step is the single-global-model "
                         "round; clustered families are not ported yet")
    n_sel = live.shape[0]
    sizes = data_sel["valid"].reshape(n_sel, -1).sum(-1).to(torch.float32)
    one = {k: p[None] for k, p in global_params.items()}
    ups, m = client_updates(one, data_sel, loss_fn, opt, fl_cfg, agg)
    new = server_update(one, {k: u[None] for k, u in ups.items()},
                        live[None], sizes[None], fl_cfg, agg)
    return {k: p[0] for k, p in new.items()}, m


def make_fl_round(loss_fn, fl_cfg, strategy_name: Optional[str] = None,
                  aggregation: "str | Aggregator | None" = None) -> Callable:
    """Build the round function

        fl_round(global_params, round_batches, hists, key=None)
            -> (new_global_params, info)

    round_batches: leaves (N, n_batches, batch_size, ...); hists: (N, C);
    key: the round's selection key (``repro_torch.rng``) for strategies that
    draw (``random``).  ``info`` holds the selection (``selected``,
    ``live``, ``mask``, ``num_selected``, ``mask_sum``, ``budget``,
    ``scores``) and the mean live-client loss."""
    strategy = get_strategy(strategy_name or fl_cfg.selection)
    agg = resolve_aggregator(aggregation, fl_cfg)
    if agg.clustered:
        raise ValueError(f"clustered aggregation (n_clusters={agg.n_clusters})"
                         " is not ported yet")
    n_sel = fl_cfg.clients_per_round
    opt = get_optimizer(fl_cfg.optimizer, fl_cfg.lr)

    def fl_round(global_params: Params, round_batches: Dict[str, torch.Tensor],
                 hists: torch.Tensor, key=None
                 ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        sel = strategy(key, hists, n_sel)
        budget = selection_budget(sel, n_sel, hists.shape[0])
        idx = sel.order[:budget].long()           # clients asked to train
        live = sel.mask[idx]                      # 0 where count < budget
        data_sel = {k: v[idx] for k, v in round_batches.items()}
        new_params, m = client_update_step(global_params, data_sel, live,
                                           loss_fn, opt, fl_cfg, agg)
        info = {
            "selected": idx.to(torch.int32),
            "live": live,
            "mask": sel.mask,
            "num_selected": live.sum(),
            # Equal to num_selected unless a mask escaped its budget window;
            # run_fl_host checks it every round.
            "mask_sum": sel.mask.sum(),
            "budget": budget,
            "client_loss": ((m["loss"] * live).sum()
                            / torch.clamp(live.sum(), min=1)),
            "scores": sel.scores,
        }
        return new_params, info

    return fl_round
