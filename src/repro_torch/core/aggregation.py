"""Server-side aggregation: the masked weighted mean over stacked clients,
server interpolation, the aggregator registry and the robust reductions.

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
