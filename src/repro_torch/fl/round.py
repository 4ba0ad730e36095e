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
to one −lr step.  Clustered families, robust reducers and the adversary
hooks come with later slices of the port.
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


def _reduce_fn(agg: Aggregator):
    """The family's masked weighted reduction: its override, or the kernel
    dispatch's ``masked_weighted_mean``."""
    return agg.reduce if agg.reduce is not None else masked_weighted_mean


def client_update_step(global_params: Params, data_sel: Dict[str, torch.Tensor],
                       live: torch.Tensor, loss_fn, opt, fl_cfg,
                       agg_kind: "str | Aggregator"
                       ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """Local training, masked aggregation and server update for the selected
    clients.  data_sel: leaves (S, n_batches, batch_size, ...); live: (S,)
    0/1.  The FedAvg weights are each client's count of valid samples.
    Returns (new global params, per-client metrics)."""
    agg = resolve_aggregator(agg_kind, fl_cfg)
    if agg.clustered:
        raise ValueError("client_update_step is the single-global-model "
                         "round; clustered families are not ported yet")
    reduce = _reduce_fn(agg)
    n_sel = live.shape[0]
    sizes = data_sel["valid"].reshape(n_sel, -1).sum(-1).to(torch.float32)
    if agg.base == "fedsgd":
        grads, m = local_gradient(global_params, data_sel, loss_fn)
        agg_g = reduce(grads, live, sizes)
        new_params = apply_updates(
            global_params, {k: -fl_cfg.lr * g for k, g in agg_g.items()})
    else:
        start = {k: p.expand((n_sel,) + p.shape)
                 for k, p in global_params.items()}
        trained, m = local_train(start, opt, data_sel, loss_fn,
                                 fl_cfg.local_epochs)
        agg_p = reduce(trained, live, sizes)
        new_params = interpolate(global_params, agg_p, fl_cfg.server_lr)
    # Algorithm 1's count = 0 case: an empty selection keeps the params (the
    # ε-denominator mean would zero them).
    any_live = live.sum() > 0
    new_params = {k: torch.where(any_live, new_params[k], old)
                  for k, old in global_params.items()}
    return new_params, m


def make_fl_round(loss_fn, fl_cfg, strategy_name: Optional[str] = None,
                  aggregation: "str | Aggregator | None" = None) -> Callable:
    """Build the round function

        fl_round(global_params, round_batches, hists, generator=None)
            -> (new_global_params, info)

    round_batches: leaves (N, n_batches, batch_size, ...); hists: (N, C);
    generator: a ``torch.Generator`` on the tensors' device for strategies
    that draw (``random``).  ``info`` holds the selection (``selected``,
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
                 hists: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        sel = strategy(generator, hists, n_sel)
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
