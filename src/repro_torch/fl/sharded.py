"""The paper's round over a ``torch.distributed`` process group, with the
training phase gather-based, so only the selected budget of clients
spends FLOPs (mirrors ``repro.fl.sharded``, whose ``shard_map`` over a
mesh axis becomes G ranks of a process group).

Each of the G ranks holds a block of C = N/G clients.  Each round, on
every rank:

1. the block's label histograms in one ``label_hist`` launch on a card
   (``kernels.dispatch.client_histograms``); an unavailable client's
   histogram is zeroed;
2. an all-gather of the (N, C_classes) histogram matrix, Algorithm 1's
   "transmit statistics to the server" step;
3. the same selection on every rank through the strategy registry (the
   port's bit-equal scores and ``topn_mask`` give every rank the same
   order), with the strategy's static budget B;
4. the exchange: the batch shards of ``order[:B_pad]`` (B padded to a
   multiple of G) move so each rank holds ``slots = B_pad/G`` selected
   clients' data; ``exchange="a2a"`` moves only those (one reduce-scatter
   over the replicated slot routing), ``"allgather"`` gathers the whole
   round batch and indexes it (the O(N) baseline; the two are
   bit-identical);
5. local training of the rank's slots at once (``local_step``, e.g.
   ``fl.client.local_train``: ``vmap(grad)`` over the slots);
6. the slots' weighted deltas summed in the rank (``weighted_sum_tree``,
   one ``weighted_agg`` launch on a card) and all-reduced into the
   replicated FedAvg mean, or all-gathered for a robust ``reduce``.

``mode="masked"`` trains every client of the block and masks the
unselected out of the mean, the reference's measured baseline.  With no
process group (``group=None``) the round is one group, every collective
the identity.

The reference's PartitionSpec arguments (``params_pspec``,
``batch_pspec``) have no counterpart: a rank holds whole tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from .. import rng
from ..core import (cluster_counts, get_strategy, interpolate,
                    kmeans_cluster, selection_budget, topn_mask)
from ..core.aggregation import (all_gather_tiled, exchange_selected_shards,
                                gather_client_shards, group_rank, group_size,
                                psum_weighted_mean)
from ..core.ordered import fma
from ..core.selection import SelectFn
from ..kernels.dispatch import client_histograms, weighted_sum_tree
from .round import start_models

Params = Dict[str, torch.Tensor]


def topn_mask_from_scores(scores: torch.Tensor,
                          n_select: int) -> torch.Tensor:
    """The deterministic top-n 0/1 mask over gathered scores, gated on
    σ² ≠ 0 (``core.selection.topn_mask``'s tie-breaking)."""
    mask, _ = topn_mask(scores, scores > 0, n_select)
    return mask


def _static_budget(select_fn: SelectFn, n_select: int, num_clients: int,
                   num_classes: int) -> int:
    """The strategy's static budget B (``SelectionResult.budget``), read
    from one call on zero histograms on the CPU: the gather width."""
    r = select_fn(rng.PRNGKey(0, "cpu"),
                  torch.zeros((num_clients, num_classes)), n_select)
    return selection_budget(r, n_select, num_clients)


def _slot_bcast(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (S,) per-slot vector shaped against a (S, ...) stacked leaf."""
    return v.reshape(v.shape + (1,) * (leaf.dim() - 1))


def make_sharded_fl_round(group, local_step: Callable[..., Params],
                          n_select: int, num_classes: int,
                          agg_dtype: Optional[torch.dtype] = None,
                          with_availability: bool = False,
                          num_clients: Optional[int] = None,
                          strategy: Union[str, SelectFn] = "labelwise",
                          server_lr: float = 1.0,
                          mode: str = "gather",
                          exchange: str = "a2a",
                          n_clusters: int = 1,
                          kmeans_iters: int = 4,
                          reduce_fn: Optional[Callable] = None,
                          poison_scale: Optional[float] = None,
                          with_stale: bool = False) -> Callable:
    """Build the round of one rank of ``group`` (a ``ProcessGroup``, or
    None for one group with no communication).

    ``local_step(params, batch) -> params`` trains S clients at once:
    leaves (S, ...) of params and (S, n_batches, batch_size, ...) of batch.
    ``num_clients`` (default one a rank) must be a multiple of the group
    size G; each rank holds ``num_clients/G`` clients.  ``strategy`` is a
    registered name or a SelectFn, whose static budget B fixes the gather
    width; ``server_lr`` the server step θ ← θ + η_s·Δ̄.

    ``mode="gather"`` trains only the ``order[:B_pad]`` slots;
    ``"masked"`` trains every client and masks the mean.  ``exchange``
    (``"a2a"`` or ``"allgather"``) is how the selected shards move in
    ``"gather"`` mode.  ``n_clusters > 1`` is the clustered round: params
    leaves carry a leading (n_clusters,) axis, every rank computes the same
    ``kmeans_cluster`` assignment from the gathered histograms, a slot
    trains from its cluster's model, and each cluster's weighted delta mean
    is one ``weighted_agg`` launch and one all-reduce; a memberless
    cluster keeps its model.  ``reduce_fn(trained, live, sizes)`` (a
    robust ``Aggregator.reduce``) replaces the delta mean by an all-gather
    of the B_pad slots' trained models (their deltas under a narrower
    ``agg_dtype``) and the reduction on every rank (gather mode, single
    model).  ``poison_scale`` and ``with_stale`` add an (N,)
    byzantine mask argument (and the τ-old params): byzantine slots train
    from the stale params and report ``base + scale·(θ' − base)``.
    ``agg_dtype`` is the deltas' dtype in the sums (bf16 halves the
    all-reduce's bytes).

    Returns ``round_fn(params, batch, labels, valid, key[, avail][, adv]
    [, stale_params]) -> (new_params, info)`` with the rank's block of
    ``batch`` leaves (C, n_batches, batch_size, ...), ``labels``/``valid``
    (C, n) and ``avail`` (C,), the replicated selection key, and the (N,)
    ``adv``.  ``info`` holds the replicated ``mask``, ``num_selected``,
    ``scores`` and the gathered ``hists`` (N, C_classes), and for a
    clustered round ``cluster_assign``, ``cluster_centroids`` and
    ``cluster_weights``.  The function carries the static facts
    ``budget``, ``budget_padded``, ``trained_per_round``,
    ``flop_sparsity``, ``mode``, ``exchange`` and ``n_clusters``."""
    if mode not in ("gather", "masked"):
        raise ValueError(f"mode must be 'gather' or 'masked'; got {mode!r}")
    if exchange not in ("a2a", "allgather"):
        raise ValueError(f"exchange must be 'a2a' or 'allgather'; "
                         f"got {exchange!r}")
    attacked = poison_scale is not None or with_stale
    if reduce_fn is not None or attacked:
        if n_clusters > 1:
            raise ValueError(
                "custom reduce overrides and engine-level adversary "
                "behaviors are single-global-model features; clustered "
                "families keep the per-cluster delta-psum pair")
        if reduce_fn is not None and mode != "gather":
            raise ValueError(
                "reduce_fn needs mode='gather' — the masked round's deltas "
                "are laid out in client-id order, not selection order")
    n_groups = group_size(group)
    n_clients = n_groups if num_clients is None else int(num_clients)
    if n_clients % n_groups:
        raise ValueError(
            f"num_clients ({n_clients}) must be a multiple of the group "
            f"size ({n_groups}) so every rank holds the same client block")
    per_group = n_clients // n_groups
    select_fn = get_strategy(strategy) if isinstance(strategy, str) else strategy

    budget = _static_budget(select_fn, n_select, n_clients, num_classes)
    slots = max(1, -(-budget // n_groups))       # selected clients a rank
    budget_padded = slots * n_groups             # static gather width <= N
    trained_per_round = budget_padded if mode == "gather" else n_clients
    dt = agg_dtype or torch.float32

    def deltas(new: Params, base: Params) -> Params:
        return {k: (new[k].to(torch.float32) - b.to(torch.float32)).to(dt)
                for k, b in base.items()}

    def server_step(params: Params, agg_delta: Params) -> Params:
        return {k: (p.to(torch.float32) + server_lr * agg_delta[k]).to(
            p.dtype) for k, p in params.items()}

    def round_fn(params: Params, batch: Dict[str, torch.Tensor],
                 labels: torch.Tensor, valid: torch.Tensor, key,
                 *extras: Any) -> Tuple[Params, Dict[str, torch.Tensor]]:
        rest = list(extras)
        avail = rest.pop(0) if with_availability else None
        adv = rest.pop(0) if attacked else None
        stale_params = rest.pop(0) if with_stale else None
        hist = client_histograms(torch.where(valid, labels, 0), num_classes,
                                 valid)
        if avail is not None:
            hist = hist * avail[:, None].to(hist.dtype)      # dark -> empty
        hists_all = all_gather_tiled(hist, group)            # (N, C)
        sel = select_fn(key, hists_all, n_select)            # replicated
        sizes = hists_all.sum(-1)                            # n_i
        g = group_rank(group)
        if mode == "gather":
            order_b = sel.order[:budget_padded].long()
            my_slots = order_b[g * slots:(g + 1) * slots]
            if exchange == "a2a":
                my_batch = exchange_selected_shards(
                    batch, order_b, group, num_groups=n_groups,
                    per_group=per_group)
            else:
                my_batch = {k: v[my_slots] for k, v in
                            gather_client_shards(batch, group).items()}
        else:
            my_slots = g * per_group + torch.arange(
                per_group, device=hist.device)
            my_batch = batch
        live = sel.mask[my_slots]             # 0 on dead and padded slots
        info = {"mask": sel.mask, "num_selected": sel.mask.sum(),
                "scores": sel.scores, "hists": hists_all}

        if n_clusters > 1:
            # Every rank computes the same assignment from the same
            # gathered histograms.
            assign, cent = kmeans_cluster(hists_all, n_clusters,
                                          n_iters=kmeans_iters)
            cl_my = assign[my_slots].long()
            params_slot = {k: p[cl_my] for k, p in params.items()}
            delta = deltas(local_step(params_slot, my_batch), params_slot)
            w = live * sizes[my_slots]
            member = cl_my[None, :] == torch.arange(
                n_clusters, device=cl_my.device)[:, None]
            w_mc = member.to(w.dtype) * w[None, :]           # (M, slots)
            # One weighted delta mean a cluster; a memberless cluster's
            # numerator is exactly zero, so its model stays as it was.
            means = [psum_weighted_mean(delta, w_mc[c], group,
                                        local_sum=weighted_sum_tree)
                     for c in range(n_clusters)]
            new_global = server_step(params, {
                k: torch.stack([m[k] for m in means]) for k in params})
            valid_all = (hists_all.sum(-1) > 0).to(torch.float32)
            info.update(cluster_assign=assign, cluster_centroids=cent,
                        cluster_weights=cluster_counts(
                            assign, n_clusters, weights=valid_all))
            return new_global, info

        n_slots = live.shape[0]
        a_sel = None if adv is None else adv[my_slots]
        # Byzantine slots under stale_update train from the τ-old global,
        # the others from the current one.
        base = start_models(
            {k: p[None] for k, p in params.items()}, n_slots,
            adv_sel=None if a_sel is None else a_sel[None],
            stale=None if stale_params is None else
            {k: p[None] for k, p in stale_params.items()})
        new_local = local_step(base, my_batch)
        if poison_scale is not None:
            # Byzantine slots report base + s·(θ' − base), one fused
            # multiply-add as the reference's CPU code rounds it.
            s = float(poison_scale)
            bad = a_sel > 0
            new_local = {k: torch.where(_slot_bcast(bad, u),
                                        fma(s, u - base[k], base[k]).to(
                                            u.dtype), u)
                         for k, u in new_local.items()}
        if reduce_fn is not None:
            # Gather-reduce: the B_pad slots' trained models on every rank,
            # reduced there; the reduction masks the dead and padded slots
            # itself.  In float32 the trained params themselves travel (the
            # bytes of float32 deltas), so the reducer sees the bits the
            # other engines reduce: the reference's params + delta rounds
            # once more, and a robust reducer passes single slots' values
            # on unaveraged, so that ulp grows through the next rounds'
            # Adam steps (scripts/torch_sharded_drift.py).  A narrower
            # agg_dtype sends the deltas and rebuilds.
            order_b = sel.order[:budget_padded].long()
            if dt == torch.float32:
                trained = {k: u.to(torch.float32) for k, u in
                           gather_client_shards(new_local, group).items()}
            else:
                delta_all = gather_client_shards(
                    deltas(new_local, params), group)
                trained = {k: p.to(torch.float32)
                           + delta_all[k].to(torch.float32)
                           for k, p in params.items()}
            live_all = sel.mask[order_b]
            agg_p = reduce_fn(trained, live_all, sizes[order_b])
            new_global = interpolate(params, agg_p, server_lr)
            any_live = live_all.sum() > 0
            return {k: torch.where(any_live, new_global[k], p)
                    for k, p in params.items()}, info
        agg_delta = psum_weighted_mean(deltas(new_local, params),
                                       live * sizes[my_slots], group,
                                       local_sum=weighted_sum_tree)
        return server_step(params, agg_delta), info

    round_fn.budget = budget
    round_fn.budget_padded = budget_padded
    round_fn.trained_per_round = trained_per_round
    round_fn.flop_sparsity = 1.0 - trained_per_round / n_clients
    round_fn.mode = mode
    round_fn.exchange = exchange if mode == "gather" else None
    round_fn.n_clusters = n_clusters
    return round_fn


def exchange_bytes_per_device(batch: Dict[str, torch.Tensor],
                              num_clients: int, budget_padded: int,
                              num_groups: int, exchange: str) -> int:
    """Analytic ring bytes a rank receives in the gather-phase exchange.
    ``batch`` leaves carry a client axis first (any block of it: a client's
    shard is ``prod(shape[1:])·itemsize`` bytes a leaf; bool leaves ride as
    int8, one byte either way).  ``allgather`` receives the other ranks'
    ``N − N/G`` shards, ``a2a`` ``B_pad − B_pad/G``."""
    if exchange not in ("a2a", "allgather"):
        raise ValueError(f"exchange must be 'a2a' or 'allgather'; "
                         f"got {exchange!r}")
    per_client = 0
    for leaf in batch.values():
        n_elems = 1
        for d in leaf.shape[1:]:
            n_elems *= int(d)
        per_client += n_elems * leaf.dtype.itemsize
    rows = num_clients if exchange == "allgather" else budget_padded
    return (rows - rows // num_groups) * per_client
