"""Server-side aggregation: the masked weighted mean over stacked clients,
server interpolation, the aggregator registry, the robust reductions and
the collectives of the sharded round.

Parameters are ``dict[str, Tensor]``; a stacked tree has a leading client
axis on every leaf.  The robust builtins (``median``, ``trimmed_mean``,
``krum``) also take a leading trial axis, leaves (T, S, …) with ``live``
(T, S), each trial reduced as if alone, so the grid engine makes one call a
round for all its trials.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

Params = Dict[str, torch.Tensor]


def _bcast(w: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a (K,) weight vector against a (K, ...) stacked leaf."""
    return w.reshape(w.shape + (1,) * (leaf.dim() - 1)).to(leaf.dtype)


def masked_mean(stacked: Params, mask: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> Params:
    """Weighted mean over the leading (client) axis, restricted to ``mask``.

    weights=None -> Algorithm 1's uniform mean over selected clients;
    weights=n_i  -> FedAvg's Eq. (1) data-size weighting.  An empty mask
    divides by ε and gives zeros; the round guards that case."""
    w = mask.to(torch.float32)
    if weights is not None:
        w = w * weights.to(torch.float32)
    denom = torch.clamp(w.sum(), min=1e-12)
    return {k: ((_bcast(w, p) * p).sum(0) / denom).to(p.dtype)
            for k, p in stacked.items()}


def interpolate(global_params: Params, aggregated: Params,
                server_lr: float = 1.0) -> Params:
    """θ ← θ + η_s (θ̄ − θ); η_s = 1 broadcasts the mean."""
    return {k: (g + server_lr * (aggregated[k] - g)).to(g.dtype)
            for k, g in global_params.items()}


# fn(stacked_updates, live, sizes) -> aggregated tree: the masked weighted
# client reduction.
AggregateFn = Callable[[Params, torch.Tensor, Optional[torch.Tensor]], Params]


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """One server-aggregation family.  ``base`` is ``"fedavg"`` (local epochs,
    parameter mean, interpolate) or ``"fedsgd"`` (one gradient, gradient mean,
    one −lr step).  ``n_clusters > 1`` makes the family clustered: every
    engine carries ``n_clusters`` global models, assigns clients to them by
    ``core.clustering.kmeans_cluster`` on the round's histograms
    (``kmeans_iters`` Lloyd iterations), trains each selected client from
    its cluster's model and reduces each cluster alone.  ``reduce``
    overrides the masked weighted reduction (:data:`AggregateFn`); ``None``
    means ``kernels.dispatch.masked_weighted_mean``, the ``weighted_agg``
    kernel on a card."""
    base: str = "fedavg"
    n_clusters: int = 1
    kmeans_iters: int = 4
    reduce: Optional[AggregateFn] = None

    def __post_init__(self):
        if self.base not in ("fedavg", "fedsgd"):
            raise ValueError(f"Aggregator.base must be 'fedavg' or 'fedsgd'; "
                             f"got {self.base!r}")
        if self.n_clusters < 1:
            raise ValueError(f"n_clusters must be >= 1; got {self.n_clusters}")

    @property
    def clustered(self) -> bool:
        return self.n_clusters > 1


# Name -> Aggregator, mutated only through register_aggregator; the order
# list is the append-only id ledger.
AGGREGATORS: Dict[str, Aggregator] = {}
_AGG_REGISTRY_ORDER: List[str] = []


def register_aggregator(name: str, agg: "Aggregator | AggregateFn", *,
                        overwrite: bool = False,
                        check: bool = False) -> Aggregator:
    """Register an aggregation family (a bare callable becomes
    ``Aggregator("fedavg", reduce=fn)``).  New names append to the id ledger;
    ``overwrite=True`` swaps the family and keeps its id.  A registered
    ``reduce`` takes one trial: leaves (S, …), ``live`` and ``sizes`` (S,).
    ``check=True``, the contract pass over a custom ``reduce``, is not ported
    yet and raises."""
    if check:
        raise NotImplementedError(
            "register_aggregator(check=True), the contract pass over a "
            "custom reduce, is not ported yet (ROADMAP Queue 1 item 16)")
    if not name or not isinstance(name, str):
        raise ValueError(f"aggregator name must be a non-empty str; got {name!r}")
    if name in AGGREGATORS and not overwrite:
        raise ValueError(
            f"aggregator {name!r} is already registered "
            f"(id {aggregator_id(name)}); pass overwrite=True to replace it")
    if callable(agg) and not isinstance(agg, Aggregator):
        agg = Aggregator(base="fedavg", reduce=agg)
    if not isinstance(agg, Aggregator):
        raise TypeError(f"aggregator {name!r} must be an Aggregator or a "
                        f"callable; got {type(agg)}")
    AGGREGATORS[name] = agg
    if name not in _AGG_REGISTRY_ORDER:
        _AGG_REGISTRY_ORDER.append(name)
    return agg


def registered_aggregators() -> Tuple[str, ...]:
    return tuple(_AGG_REGISTRY_ORDER)


def aggregator_id(name: str) -> int:
    try:
        return _AGG_REGISTRY_ORDER.index(name)
    except ValueError:
        raise KeyError(f"unknown aggregator {name!r}; have "
                       f"{registered_aggregators()}") from None


def get_aggregator(name: str) -> Aggregator:
    try:
        return AGGREGATORS[name]
    except KeyError:
        raise KeyError(f"unknown aggregator {name!r}; have "
                       f"{registered_aggregators()}") from None


# Ids 0-5, as in the reference: the two base families, their 2-cluster
# forms, then the cluster-count sweep.
register_aggregator("fedavg", Aggregator("fedavg"))
register_aggregator("fedsgd", Aggregator("fedsgd"))
register_aggregator("clustered_fedavg", Aggregator("fedavg", n_clusters=2))
register_aggregator("clustered_fedsgd", Aggregator("fedsgd", n_clusters=2))
register_aggregator("clustered_fedavg4", Aggregator("fedavg", n_clusters=4))
register_aggregator("clustered_fedavg8", Aggregator("fedavg", n_clusters=8))


# ---------------------------------------------------------------------------
# Robust reductions (ids 6-8).  Each ignores ``sizes`` (a byzantine client
# reports its own n_i), masks dead slots and works from the live count
# c = Σ live of its trial.  They round as the reference's compiled CPU code
# does: sorts are exact, the median averages two ranks as 0.5·(a + b), the
# trimmed mean sums the sorted slots left to right.
# ---------------------------------------------------------------------------

def _trials(stacked: Params, live: torch.Tensor):
    """A one-trial call (``live`` (S,)) as a batch of one: -> (leaves
    (T, S, …), live (T, S), whether to drop the trial axis again)."""
    if live.dim() == 1:
        return {k: p[None] for k, p in stacked.items()}, live[None], True
    return stacked, live, False


def _untrial(tree: Params, squeeze: bool) -> Params:
    return {k: p[0] for k, p in tree.items()} if squeeze else tree


def _sorted_live(p: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(T, S, …) leaf in float32 with dead slots at +inf, sorted over S."""
    on = live.reshape(live.shape + (1,) * (p.dim() - 2)) > 0
    x = torch.where(on, p.to(torch.float32), torch.inf)
    return torch.sort(x, dim=1).values


def _take_rank(x: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """x (T, S, …) at per-trial rank (T,) -> (T, …)."""
    idx = rank.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
        (x.shape[0], 1) + x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


def median_reduce(stacked: Params, live: torch.Tensor,
                  sizes: Optional[torch.Tensor] = None) -> Params:
    """Coordinate-wise median over the live slots: the mean of ranks
    ⌊(c−1)/2⌋ and ⌊c/2⌋ of the sorted values (``torch.median`` would give
    the lower one).  c = 0 gives +inf, which the engines' count = 0 guard
    discards."""
    del sizes
    stacked, lv, squeeze = _trials(stacked, live)
    c = torch.clamp(lv.to(torch.int32).sum(-1), min=1).long()
    lo, hi = (c - 1) // 2, c // 2

    def med(p: torch.Tensor) -> torch.Tensor:
        x = _sorted_live(p, lv)
        return (0.5 * (_take_rank(x, lo) + _take_rank(x, hi))).to(p.dtype)

    return _untrial({k: med(p) for k, p in stacked.items()}, squeeze)


def make_trimmed_mean(trim_frac: float = 0.25) -> AggregateFn:
    """Coordinate-wise ``trim_frac``-trimmed mean: of the c sorted live
    values drop the k = ⌊f32(trim_frac)·f32(c)⌋ smallest and largest and
    average the rest, uniformly."""
    if not 0.0 <= trim_frac < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5); got {trim_frac}")
    frac = torch.tensor(trim_frac, dtype=torch.float32)

    def reduce(stacked: Params, live: torch.Tensor,
               sizes: Optional[torch.Tensor] = None) -> Params:
        del sizes
        stacked, lv, squeeze = _trials(stacked, live)
        c = lv.to(torch.int32).sum(-1)
        k = (frac.to(lv.device) * c.to(torch.float32)).to(torch.int32)
        denom = torch.clamp(c - 2 * k, min=1).to(torch.float32)
        r = torch.arange(lv.shape[1], device=lv.device)
        keep = (r >= k[:, None]) & (r < (c - k)[:, None])      # (T, S)

        def trim(p: torch.Tensor) -> torch.Tensor:
            x = _sorted_live(p, lv)
            x = torch.where(keep.reshape(keep.shape + (1,) * (x.dim() - 2)),
                            x, 0.0)
            acc = torch.zeros_like(x[:, 0])
            for s in range(x.shape[1]):
                acc = acc + x[:, s]
            return (acc / denom.reshape((-1,) + (1,) * (acc.dim() - 1))
                    ).to(p.dtype)

        return _untrial({k_: trim(p) for k_, p in stacked.items()}, squeeze)

    reduce.trial_axis = True
    return reduce


# Two-tier (hierarchical) reduction: edge partial sums, then the global
# combine, the ``hier`` engine's and the population round's aggregation rule.

def block_partial_sums(stacked: Params, weights: torch.Tensor,
                       block_ids: torch.Tensor, num_blocks: int
                       ) -> Tuple[Params, torch.Tensor]:
    """Each edge's Σ_{i∈b} w_i·x_i and Σ_{i∈b} w_i: leaves (S, …) with
    ``block_ids`` (S,) in [0, num_blocks) -> the (num_blocks, …) partial
    tree and the (num_blocks,) weight sums, float32.  The products are taken
    in float64 and rounded once to float32, so no TF32 reaches them
    whatever ``torch.backends`` says."""
    ids = block_ids.to(torch.int64)
    member = ids[None, :] == torch.arange(num_blocks, device=ids.device)[:, None]
    w_eb = member.to(torch.float32) * weights.to(torch.float32)[None, :]
    w64 = w_eb.to(torch.float64)
    num = {k: (w64 @ x.reshape(x.shape[0], -1).to(torch.float64))
           .to(torch.float32).reshape((num_blocks,) + x.shape[1:])
           for k, x in stacked.items()}
    return num, w_eb.sum(-1)


def two_tier_weighted_mean(stacked: Params, mask: torch.Tensor,
                           weights: Optional[torch.Tensor],
                           block_ids: torch.Tensor, num_blocks: int) -> Params:
    """Σ_e (Σ_{i∈e} w·x) / Σ_e (Σ_{i∈e} w) with w = mask·weights: the flat
    FedAvg mean reassociated over edges, with :func:`masked_mean`'s
    ε-denominator (an empty selection gives zeros; the engines guard it)."""
    w = mask.to(torch.float32)
    if weights is not None:
        w = w * weights.to(torch.float32)
    num, den = block_partial_sums(stacked, w, block_ids, num_blocks)
    denom = torch.clamp(den.sum(), min=1e-12)
    return {k: (num[k].sum(0) / denom).to(x.dtype)
            for k, x in stacked.items()}


# Krum's finite sentinels: an excluded pair stays summable, so a round with
# one live client still scores it below every dead slot.
_KRUM_EXCLUDED, _KRUM_DEAD = 1e30, 1e35


def krum_scores(stacked: Params, live: torch.Tensor,
                byzantine_frac: float = 0.25) -> torch.Tensor:
    """Krum's score of every slot, (T, S) float64 for leaves (T, S, …):
    the sum of its m = c − f − 2 smallest squared distances to other live
    slots (f = ⌊f32(byzantine_frac)·f32(c)⌋), dead slots + 1e35.

    The distances are the reference's sq_i + sq_j − 2·θ_i·θ_j, taken in
    float64 (a product of float32 values is exact there), so no TF32 or
    float32 cancellation reaches them whatever the caller has set in
    ``torch.backends``."""
    lv = live.to(torch.float64)
    c = live.to(torch.int32).sum(-1)
    f = (torch.tensor(byzantine_frac, dtype=torch.float32, device=live.device)
         * c.to(torch.float32)).to(torch.int32)
    t, s = live.shape
    gram = torch.zeros((t, s, s), dtype=torch.float64, device=live.device)
    for p in stacked.values():
        flat = p.reshape(t, s, -1).to(torch.float64)
        gram = gram + flat @ flat.transpose(1, 2)
    sq = torch.diagonal(gram, dim1=1, dim2=2)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
    excl = (torch.eye(s, dtype=torch.bool, device=live.device)[None]
            | (lv[:, None, :] == 0))
    d2 = torch.where(excl, _KRUM_EXCLUDED, torch.clamp(d2, min=0.0))
    m = torch.clamp(c - f - 2, min=1, max=s - 1)
    d2 = torch.sort(d2, dim=2).values
    near = torch.arange(s, device=live.device)[None, None, :] < m[:, None, None]
    score = torch.where(near, d2, 0.0).sum(-1)
    return score + (1.0 - lv) * _KRUM_DEAD


def make_krum(byzantine_frac: float = 0.25) -> AggregateFn:
    """Krum (Blanchard et al. 2017): return the whole tree of the one live
    slot with the smallest :func:`krum_scores` (the first on a tie)."""
    if not 0.0 <= byzantine_frac < 0.5:
        raise ValueError(
            f"byzantine_frac must be in [0, 0.5); got {byzantine_frac}")

    def reduce(stacked: Params, live: torch.Tensor,
               sizes: Optional[torch.Tensor] = None) -> Params:
        del sizes
        stacked, lv, squeeze = _trials(stacked, live)
        score = krum_scores(stacked, lv, byzantine_frac)
        slot = torch.arange(score.shape[1], device=score.device)
        sel = torch.where(score == score.min(-1, keepdim=True).values, slot,
                          score.shape[1]).min(-1).values    # first on a tie
        trial = torch.arange(lv.shape[0], device=lv.device)
        return _untrial({k: p[trial, sel] for k, p in stacked.items()},
                        squeeze)

    reduce.trial_axis = True
    return reduce


median_reduce.trial_axis = True
trimmed_mean_reduce = make_trimmed_mean()
krum_reduce = make_krum()

register_aggregator("median", Aggregator("fedavg", reduce=median_reduce))
register_aggregator("trimmed_mean",
                    Aggregator("fedavg", reduce=trimmed_mean_reduce))
register_aggregator("krum", Aggregator("fedavg", reduce=krum_reduce))


# ---------------------------------------------------------------------------
# Collective forms over a ``torch.distributed`` process group: a group of G
# ranks, each holding its own block of clients (the reference's shard_map
# over a mesh axis).  ``group=None`` is one group with no communication,
# where every collective is the identity.  A rank's index within the group
# plays the reference's ``axis_index``:
#
#   tiled all_gather -> all_gather_into_tensor
#   psum_scatter(tiled=True) -> reduce_scatter_tensor
#   psum -> all_reduce(SUM)
#
# Two regimes, as in the reference: the masked psum (psum_aggregate, every
# rank computes and the mask zeroes unselected contributions) and the
# gather/scatter of the gather-based round (gather_client_shards or
# exchange_selected_shards, then psum_weighted_mean).  Bool tensors ride the
# collectives as int8.
# ---------------------------------------------------------------------------

# torch 2.13 renames the tensor forms (``*_single``); older releases have
# only the names the mapping above gives.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor", None)


def group_size(group: "dist.ProcessGroup | None") -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: "dist.ProcessGroup | None") -> int:
    return 0 if group is None else dist.get_rank(group)


def _as_wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.to(torch.int8) if x.dtype == torch.bool else x


def _from_wire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(torch.bool) if dtype == torch.bool else x


def all_reduce_sum(x: torch.Tensor,
                   group: "dist.ProcessGroup | None") -> torch.Tensor:
    """``psum``: the sum of ``x`` over the group's ranks, on every rank, in
    ``x``'s dtype (a new tensor)."""
    if group is None:
        return x
    out = _as_wire(x).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return _from_wire(out, x.dtype)


def all_gather_tiled(x: torch.Tensor,
                     group: "dist.ProcessGroup | None") -> torch.Tensor:
    """Tiled ``all_gather``: every rank's (C, ...) block -> the (G·C, ...)
    concatenation in rank order, on every rank."""
    if group is None:
        return x
    wire = _as_wire(x)
    out = wire.new_empty((group_size(group) * x.shape[0],) + x.shape[1:])
    _ALL_GATHER(out, wire, group=group)
    return _from_wire(out, x.dtype)


def reduce_scatter_tiled(x: torch.Tensor,
                         group: "dist.ProcessGroup | None") -> torch.Tensor:
    """Tiled ``psum_scatter`` over the leading axis: the ranks' (G·S, ...)
    tensors summed, rank g keeping rows [g·S, (g+1)·S)."""
    if group is None:
        return x
    g = group_size(group)
    if x.shape[0] % g:
        raise ValueError(f"leading axis ({x.shape[0]}) must be a multiple "
                         f"of the group size ({g})")
    wire = _as_wire(x)
    out = wire.new_empty((x.shape[0] // g,) + x.shape[1:])
    _REDUCE_SCATTER(out, wire, op=dist.ReduceOp.SUM, group=group)
    return _from_wire(out, x.dtype)


def psum_aggregate(params: Params, my_mask: torch.Tensor,
                   group: "dist.ProcessGroup | None",
                   my_weight: Optional[torch.Tensor] = None) -> Params:
    """Masked weighted all-reduce of each rank's client params: every rank
    contributes mask·w·θ and the Σ w denominator makes the result the
    FedAvg mean over the selected ranks, replicated on all of them.  The
    sum runs in each leaf's dtype and the mean is finished in float32."""
    w = my_mask.to(torch.float32)
    if my_weight is not None:
        w = w * my_weight.to(torch.float32)
    denom = torch.clamp(all_reduce_sum(w, group), min=1e-12)
    return {k: (all_reduce_sum(p * w.to(p.dtype), group).to(torch.float32)
                / denom).to(p.dtype) for k, p in params.items()}


def all_gather_scores(score: torch.Tensor,
                      group: "dist.ProcessGroup | None") -> torch.Tensor:
    """Every rank's selection statistic stacked on a new leading (G,) axis
    (Algorithm 1's cheap server step: G scalars, not G models)."""
    return all_gather_tiled(score[None], group)


def gather_client_shards(tree: Params,
                         group: "dist.ProcessGroup | None") -> Params:
    """Tiled all-gather of every leaf's client axis: each rank's (C, ...)
    block -> the (N, ...) whole on every rank (the gather-based round's
    O(N) baseline exchange)."""
    return {k: all_gather_tiled(x, group) for k, x in tree.items()}


def exchange_selected_shards(tree: Params, order_padded: torch.Tensor,
                             group: "dist.ProcessGroup | None", *,
                             num_groups: int, per_group: int) -> Params:
    """The O(B) selected-shard exchange: move only the ``B_pad =
    len(order_padded)`` selected clients' shards.

    Selection is replicated, so every rank computes the same routing:
    training slot j holds client ``order_padded[j]``, which lives on rank
    ``order_padded[j] // per_group`` at local row ``order_padded[j] %
    per_group`` and trains on rank ``j // slots``.  Each rank fills its own
    clients' slots of a (B_pad, ...) tensor, zeros elsewhere, and one
    reduce-scatter sums the ranks' tensors and hands each rank its
    (slots, ...) block.  A slot sums one owner's row and zeros, so the
    result is bit-identical to all-gather-then-index."""
    b_pad = order_padded.shape[0]
    if b_pad % num_groups:
        raise ValueError(f"padded budget ({b_pad}) must be a multiple of the "
                         f"group count ({num_groups})")
    order = order_padded.long()
    src_row = order % per_group
    mine = (order // per_group) == group_rank(group)

    def route(x: torch.Tensor) -> torch.Tensor:
        contrib = _as_wire(x)[src_row]
        keep = mine.reshape((b_pad,) + (1,) * (contrib.dim() - 1))
        contrib = torch.where(keep, contrib, torch.zeros_like(contrib))
        return _from_wire(reduce_scatter_tiled(contrib, group), x.dtype)

    return {k: route(x) for k, x in tree.items()}


def psum_weighted_mean(tree: Params, weights: torch.Tensor,
                       group: "dist.ProcessGroup | None",
                       local_sum: Optional[Callable[[Params, torch.Tensor],
                                                    Params]] = None
                       ) -> Params:
    """Weighted mean over every rank's training slots: leaves (S, ...) and
    per-slot weights (S,) -> ``Σ_ranks Σ_s w·x / Σ w`` in float32,
    replicated on every rank.  The slot sum and the all-reduce run in each
    leaf's dtype (a bf16 delta tree halves the all-reduce's bytes); an
    all-zero weight vector gives an exact zero through the 1e-12
    denominator.  ``local_sum(tree, w)`` replaces the in-rank slot sum
    (leaf dtype kept): the sharded round passes
    ``kernels.dispatch.weighted_sum_tree``, one ``weighted_agg`` launch for
    the tree on a card."""
    w = weights.to(torch.float32)
    denom = torch.clamp(all_reduce_sum(w.sum(), group), min=1e-12)
    if local_sum is None:
        def local_sum(t: Params, wv: torch.Tensor) -> Params:
            return {k: (_bcast(wv, x) * x).sum(0) for k, x in t.items()}
    return {k: all_reduce_sum(s, group).to(torch.float32) / denom
            for k, s in local_sum(tree, w).items()}
