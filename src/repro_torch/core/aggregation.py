"""Server-side aggregation: the masked weighted mean over stacked clients,
server interpolation, and the aggregator registry.

Parameters are ``dict[str, Tensor]``; a stacked tree has a leading client
axis on every leaf.
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
    one −lr step).  ``n_clusters > 1`` makes the family clustered and
    ``reduce`` overrides the reduction; this slice of the port runs neither."""
    base: str = "fedavg"
    n_clusters: int = 1
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
                        overwrite: bool = False) -> Aggregator:
    """Register an aggregation family (a bare callable becomes
    ``Aggregator("fedavg", reduce=fn)``).  New names append to the id ledger;
    ``overwrite=True`` swaps the family and keeps its id."""
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


# Ids 0 and 1, as in the reference; its clustered (2-5) and robust (6-8)
# families are appended in the same order by later slices.
register_aggregator("fedavg", Aggregator("fedavg"))
register_aggregator("fedsgd", Aggregator("fedsgd"))
