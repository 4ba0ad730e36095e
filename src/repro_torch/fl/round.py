"""One FL round (paper Algorithm 1).

Per round T:
  1. every client has reported its label histogram (``hists``),
  2. the strategy ranks clients; the server asks ``order[:budget]`` to train,
     with ``budget`` the strategy's static slot count,
  3. only those clients train locally, batched over the client axis, each
     from its own start model (its cluster's model for a clustered family,
     the τ-old global for a ``stale_update`` client, else the global),
  4. masked weighted aggregation (FedAvg Eq. 1 with the clients' sample
     counts as weights) through the weighted_agg kernel on a CUDA device, or
     the family's robust ``reduce``; a clustered family reduces each cluster
     alone,
  5. the server interpolates; an empty selection leaves the params as they
     were (Algorithm 1's count = 0 case, per cluster when clustered).

``aggregation='fedsgd'`` switches clients to one gradient each and the server
to one −lr step.  Steps 3–5 (:func:`client_updates`, :func:`server_update`)
take a leading trial axis: the grid engine (``sim.py``) runs them for every
trial of a grid at once, the host round with one.

The adversary hooks follow the reference: byzantine slots ``poison`` their
report (``base + scale·(θ' − base)`` for FedAvg, ``scale·g`` for FedSGD) and
``stale_update`` slots train from a τ-rounds-old global.  All default off,
which runs exactly the round without them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core import (Aggregator, cluster_counts, get_aggregator, get_strategy,
                    interpolate, kmeans_cluster, selection_budget)
from ..core.ordered import fma
from ..kernels.dispatch import masked_weighted_mean
from ..optim import apply_updates, get_optimizer
from .client import local_gradient, local_train

Params = Dict[str, torch.Tensor]


def resolve_aggregator(agg: "str | Aggregator | None", fl_cfg) -> Aggregator:
    """Name (or None -> ``fl_cfg.aggregation``) -> registered Aggregator."""
    if isinstance(agg, Aggregator):
        return agg
    return get_aggregator(agg or fl_cfg.aggregation)


def resolve_adversary(adversary: "dict | None") -> Tuple[Optional[float], int]:
    """An adversary dict -> ``(poison_scale, tau)``: ``poison_scale`` is the
    poison multiplier (``scale``, default −1.0) when ``"poison"`` is among
    the ``behaviors``, else None; ``tau`` the staleness of a
    ``stale_update`` client (``tau``, default 1), else 0.  ``(None, 0)``
    means no engine-level behavior (``label_flip`` is a plan transform)."""
    cfg = dict(adversary or {})
    behaviors = tuple(cfg.get("behaviors", ()))
    unknown = set(behaviors) - {"poison", "stale_update"}
    if unknown:
        raise ValueError(f"unknown adversary behaviors {sorted(unknown)}; "
                         "have ['poison', 'stale_update'] (label_flip is a "
                         "plan-level transform, not an engine behavior)")
    poison_scale = (float(cfg.get("scale", -1.0))
                    if "poison" in behaviors else None)
    tau = int(cfg.get("tau", 1)) if "stale_update" in behaviors else 0
    if tau < 0:
        raise ValueError(f"adversary tau must be >= 0; got {tau}")
    return poison_scale, tau


def check_adversary(agg: Aggregator, poison_scale: Optional[float],
                    tau: int) -> None:
    """The reference's rules: behaviors need a single-model family, and
    ``stale_update`` a FedAvg one (a FedSGD client has no training base)."""
    if (poison_scale is not None or tau > 0) and agg.clustered:
        raise ValueError(
            "engine-level adversary behaviors (poison/stale_update) are not "
            "defined for clustered aggregation families; use the plan-level "
            "label_flip transform or a single-global-model aggregator")
    if tau > 0 and agg.base == "fedsgd":
        raise ValueError(
            "stale_update needs a stale TRAINING base; the fedsgd family "
            "reports one gradient at the current global, so the behavior is "
            "undefined for it")


def stack_global_params(params: Params, n_clusters: int,
                        axis: int = 0) -> Params:
    """``n_clusters`` copies of one global model on a new axis ``axis``
    (leaves (M, …), or (T, M, …) with ``axis=1`` for a trial-stacked
    model): every cluster starts from the same init."""
    def stack(p: torch.Tensor) -> torch.Tensor:
        q = p.unsqueeze(axis)
        shape = list(q.shape)
        shape[axis] = n_clusters
        return q.expand(shape).clone()
    return {k: stack(p) for k, p in params.items()}


def _slots(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (K,) per-slot vector shaped to broadcast against a (K, …) leaf."""
    return v.reshape(v.shape + (1,) * (leaf.dim() - v.dim()))


def client_updates(start: Params, data: Dict[str, torch.Tensor], loss_fn,
                   opt, fl_cfg, agg: Aggregator, *,
                   adv: Optional[torch.Tensor] = None,
                   poison_scale: Optional[float] = None,
                   want_norms: bool = False
                   ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """What K slots report, trained at once: the T·S slots of T trials,
    trial-major.

    start: leaves (K, …), the model each slot trains from; data: leaves
    (K, n_batches, batch_size, …).  A slot reports its trained params
    (FedAvg) or the mean of its minibatch gradients at its start (FedSGD).
    With ``poison_scale``, slots where ``adv`` (K,) is 1 report
    ``start + scale·(θ' − start)`` (one fused multiply-add, as the
    reference's CPU code rounds it) or ``scale·g``.  Returns (K, …) leaves
    and {"loss": (K,)}, plus ``"update_norm"`` (K,), the ℓ₂ norm of each
    as-reported update, when ``want_norms``."""
    if agg.base == "fedsgd":
        ups, m = local_gradient(start, data, loss_fn)
    else:
        ups, m = local_train(start, opt, data, loss_fn, fl_cfg.local_epochs)
    if poison_scale is not None:
        if adv is None:
            raise ValueError("poison needs the per-slot adv mask to know "
                             "which clients misbehave")
        s = float(poison_scale)
        bad = adv > 0

        def report(k: str, u: torch.Tensor) -> torch.Tensor:
            flip = (s * u if agg.base == "fedsgd"
                    else fma(s, u - start[k], start[k]))
            return torch.where(_slots(bad, u), flip.to(u.dtype), u)

        ups = {k: report(k, u) for k, u in ups.items()}
    if want_norms:
        sq = sum(((u - (0 if agg.base == "fedsgd" else start[k]))
                  .to(torch.float32) ** 2).reshape(u.shape[0], -1).sum(-1)
                 for k, u in ups.items())
        m = dict(m, update_norm=torch.sqrt(sq))
    return ups, m


def _reduce(agg: Aggregator, updates: Params, live: torch.Tensor,
            sizes: torch.Tensor) -> Params:
    """The family's reduction of T trials, leaves (T, S, …) -> (T, …): one
    ``masked_weighted_mean`` (one ``weighted_agg`` launch on a card), one
    call of a builtin robust reducer, or a registered ``reduce`` a trial at
    a time (its contract has no trial axis)."""
    if agg.reduce is None:
        return masked_weighted_mean(updates, live, sizes)
    if getattr(agg.reduce, "trial_axis", False):
        return agg.reduce(updates, live, sizes)
    outs = [agg.reduce({k: u[i] for k, u in updates.items()}, live[i],
                       sizes[i]) for i in range(live.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in updates}


def server_step(global_params: Params, red: Params, live: torch.Tensor,
                fl_cfg, agg: Aggregator) -> Params:
    """Server step of T models from their reductions (leaves (T, …)): a
    −lr step on the mean gradient (FedSGD) or the interpolation toward the
    mean (FedAvg); a model whose ``live`` (T, S) row is empty keeps its
    params."""
    if agg.base == "fedsgd":
        new = apply_updates(global_params,
                            {k: -fl_cfg.lr * g for k, g in red.items()})
    else:
        new = interpolate(global_params, red, fl_cfg.server_lr)
    any_live = live.sum(-1) > 0
    return {k: torch.where(_slots(any_live, old), new[k], old)
            for k, old in global_params.items()}


def server_update(global_params: Params, updates: Params, live: torch.Tensor,
                  sizes: torch.Tensor, fl_cfg, agg: Aggregator,
                  assign: Optional[torch.Tensor] = None) -> Params:
    """Masked reduction and server step of T models at once.

    global_params: leaves (T, …), or (T, M, …) for a clustered family;
    updates: leaves (T, S, …) from :func:`client_updates`; live, sizes:
    (T, S), the FedAvg weights being each client's count of valid samples.
    A clustered family takes ``assign`` (T, S), each slot's cluster, and
    reduces cluster c over the slots ``live · (assign == c)`` of all trials
    in one reduction (M ``weighted_agg`` launches a round), reading the
    update stack in place.  A trial (or a trial's cluster) with no live
    client keeps its params (Algorithm 1's count = 0 case: the
    ε-denominator mean would zero them)."""
    if not agg.clustered:
        return server_step(global_params,
                           _reduce(agg, updates, live, sizes), live,
                           fl_cfg, agg)
    models = []
    for c in range(agg.n_clusters):
        live_c = live * (assign == c).to(live.dtype)
        models.append(server_step(
            {k: p[:, c] for k, p in global_params.items()},
            _reduce(agg, updates, live_c, sizes), live_c, fl_cfg, agg))
    return {k: torch.stack([m[k] for m in models], 1) for k in global_params}


def _sizes(data_sel: Dict[str, torch.Tensor]) -> torch.Tensor:
    n_sel = data_sel["valid"].shape[0]
    return data_sel["valid"].reshape(n_sel, -1).sum(-1).to(torch.float32)


def start_models(params: Params, budget: int, *,
                 assign_sel: Optional[torch.Tensor] = None,
                 adv_sel: Optional[torch.Tensor] = None,
                 stale: Optional[Params] = None) -> Params:
    """The model each of T trials' ``budget`` slots trains from, leaves
    (T·budget, …), trial-major: its cluster's model (``params`` leaves
    (T, M, …), ``assign_sel`` (T, budget) each slot's cluster), else for a
    byzantine slot (``adv_sel`` (T, budget) > 0) under ``stale_update`` the
    τ-old global ``stale`` (leaves (T, …)), else its trial's global."""
    out = {}
    for k, p in params.items():
        n = p.shape[0]
        if assign_sel is not None:
            trial = torch.arange(n, device=p.device)[:, None]
            s = p[trial, assign_sel.long()]
        else:
            s = p[:, None].expand((n, budget) + p.shape[1:])
            if stale is not None:
                bad = (adv_sel > 0).reshape((n, budget) + (1,) * (p.dim() - 1))
                s = torch.where(bad, stale[k][:, None], s)
        out[k] = s.reshape((-1,) + s.shape[2:])
    return out


def _one(tree: Optional[Params]) -> Optional[Params]:
    """A one-trial tree: a leading trial axis of 1."""
    return None if tree is None else {k: v[None] for k, v in tree.items()}


def client_update_step(global_params: Params, data_sel: Dict[str, torch.Tensor],
                       live: torch.Tensor, loss_fn, opt, fl_cfg,
                       agg_kind: "str | Aggregator", *,
                       assign_sel: Optional[torch.Tensor] = None,
                       adv: Optional[torch.Tensor] = None,
                       poison_scale: Optional[float] = None,
                       stale_params: Optional[Params] = None,
                       want_client_norms: bool = False
                       ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """Local training, masked aggregation and server update for the selected
    clients of one trial: :func:`start_models`, :func:`client_updates` and
    :func:`server_update` with one trial.  data_sel: leaves (S, n_batches,
    batch_size, …); live: (S,) 0/1.  A clustered family takes the (M, …)
    stacked params and ``assign_sel`` (S,), each slot's cluster.  ``adv``
    (S,) marks the byzantine slots for ``poison_scale`` and for
    ``stale_params`` (the τ-old global they train from).  Returns (new
    params, per-client metrics)."""
    agg = resolve_aggregator(agg_kind, fl_cfg)
    if agg.clustered != (assign_sel is not None):
        raise ValueError("a clustered family needs assign_sel, the cluster "
                         "of each training slot, and only a clustered family "
                         "takes it")
    if (poison_scale is not None or stale_params is not None) and adv is None:
        raise ValueError("poison_scale/stale_params need the per-slot adv "
                         "mask to know which clients misbehave")
    one_assign = None if assign_sel is None else assign_sel[None]
    start = start_models(_one(global_params), live.shape[0],
                         assign_sel=one_assign,
                         adv_sel=None if adv is None else adv[None],
                         stale=_one(stale_params))
    ups, m = client_updates(start, data_sel, loss_fn, opt, fl_cfg, agg,
                            adv=adv, poison_scale=poison_scale,
                            want_norms=want_client_norms)
    new = server_update(_one(global_params), _one(ups), live[None],
                        _sizes(data_sel)[None], fl_cfg, agg,
                        assign=one_assign)
    return {k: p[0] for k, p in new.items()}, m


def clustered_update_step(global_stack: Params, cluster_sel: torch.Tensor,
                          data_sel: Dict[str, torch.Tensor],
                          live: torch.Tensor, loss_fn, opt, fl_cfg,
                          agg: Aggregator
                          ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """The reference's clustered round of one trial: :func:`client_update_step`
    with ``global_stack`` leaves (M, …) and ``cluster_sel`` (S,) the cluster
    of each training slot."""
    return client_update_step(global_stack, data_sel, live, loss_fn, opt,
                              fl_cfg, agg, assign_sel=cluster_sel)


def make_fl_round(loss_fn, fl_cfg, strategy_name: Optional[str] = None,
                  aggregation: "str | Aggregator | None" = None, *,
                  poison_scale: Optional[float] = None,
                  with_stale: bool = False,
                  want_client_norms: bool = False) -> Callable:
    """Build the round function

        fl_round(global_params, round_batches, hists, key=None, adv=None,
                 stale_params=None) -> (new_global_params, info)

    round_batches: leaves (N, n_batches, batch_size, …); hists: (N, C);
    key: the round's selection key (``repro_torch.rng``) for strategies that
    draw (``random``).  ``info`` holds the selection (``selected``,
    ``live``, ``mask``, ``num_selected``, ``mask_sum``, ``budget``,
    ``scores``) and the mean live-client loss.

    A clustered family takes and returns the (M, …) stacked params
    (:func:`stack_global_params`) and adds ``cluster_assign`` (N,),
    ``cluster_centroids`` (M, C) and ``cluster_weights`` (M,), the valid
    population of each cluster.  ``poison_scale``/``with_stale`` (see
    :func:`client_update_step`) read the (N,) byzantine mask ``adv`` and
    the τ-old params ``stale_params``; ``want_client_norms`` adds
    ``client_update_norms`` (N,), zero for clients that did not train."""
    strategy = get_strategy(strategy_name or fl_cfg.selection)
    agg = resolve_aggregator(aggregation, fl_cfg)
    check_adversary(agg, poison_scale, 1 if with_stale else 0)
    n_sel = fl_cfg.clients_per_round
    opt = get_optimizer(fl_cfg.optimizer, fl_cfg.lr)

    def fl_round(global_params: Params, round_batches: Dict[str, torch.Tensor],
                 hists: torch.Tensor, key=None,
                 adv: Optional[torch.Tensor] = None,
                 stale_params: Optional[Params] = None
                 ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        sel = strategy(key, hists, n_sel)
        budget = selection_budget(sel, n_sel, hists.shape[0])
        idx = sel.order[:budget].long()           # clients asked to train
        live = sel.mask[idx]                      # 0 where count < budget
        data_sel = {k: v[idx] for k, v in round_batches.items()}
        extra, assign_sel = {}, None
        if agg.clustered:
            assign, cent = kmeans_cluster(hists, agg.n_clusters,
                                          n_iters=agg.kmeans_iters)
            assign_sel = assign[idx]
            valid = (hists.sum(-1) > 0).to(torch.float32)
            extra = {"cluster_assign": assign, "cluster_centroids": cent,
                     "cluster_weights": cluster_counts(
                         assign, agg.n_clusters, weights=valid)}
        new_params, m = client_update_step(
            global_params, data_sel, live, loss_fn, opt, fl_cfg, agg,
            assign_sel=assign_sel, adv=None if adv is None else adv[idx],
            poison_scale=poison_scale,
            stale_params=stale_params if with_stale else None,
            want_client_norms=want_client_norms)
        if want_client_norms:
            extra["client_update_norms"] = torch.zeros(
                hists.shape[0], dtype=torch.float32, device=hists.device
            ).index_put((idx,), m["update_norm"] * live)
        info = {
            **extra,
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
