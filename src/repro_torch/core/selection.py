"""Client-selection strategies (paper Algorithm 1, baselines and ablations).

Every strategy has the signature

    select(key, hists, n_select) -> SelectionResult(mask, scores, order, budget)

with ``hists`` the (…, N, C) per-client label-histogram matrix of the round
and ``key`` a ``repro_torch.rng`` key (…, 2) (only ``random`` draws from it).
Leading axes are independent rounds (the grid engine's trials), each
selected as if alone.  ``mask`` is a float32 (…, N) 0/1 vector of chosen
clients and
``budget`` the static number of training slots: the round trains exactly
``order[:budget]``, and ``mask[order[:budget]]`` says which of those are live.
Invalid clients are scored −∞ and masked out, so Algorithm 1's "if count < n
then n = count" degradation leaves the tail of the window dead, never
replaced.

Built-in strategies (ids in registration order, append-only, as in the
reference): random, labelwise (THE PAPER: σ² ≠ 0 gate, top-n by σ²/n_i),
labelwise_unnorm, coverage, kl, entropy, full, labelwise_priority (id 7),
and dirichlet_uniformity (id 8, registered by ``fl.experiment`` through
:func:`register_strategy`, as the reference registers it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import rng
from .clustering import area_index, selection_priority
from .kl import uniformity_score
from .label_stats import empirical_pdf, label_variance, label_variance_normed
from .ordered import class_dot, class_sum, log

NEG_INF = -1e30


@dataclass
class SelectionResult:
    """One round's selection decision: ``order`` sorts clients by descending
    priority with invalid clients last; ``budget`` is the static gather width
    (``None`` means the engine's ``clients_per_round``)."""
    mask: torch.Tensor    # (…, N) float32 ∈ {0, 1}
    scores: torch.Tensor  # (…, N) float32, the strategy's ranking statistic
    order: torch.Tensor   # (…, N) int32, descending priority, invalid last
    budget: Optional[int] = None


def selection_budget(result: SelectionResult, n_select: int,
                     num_clients: int) -> int:
    """``result.budget`` if declared, else ``n_select``, clamped to [0, N]."""
    b = n_select if result.budget is None else result.budget
    if not isinstance(b, int):
        raise ValueError("SelectionResult.budget must be a Python int (it is "
                         f"the round's gather width); got {type(b)}")
    return max(0, min(b, int(num_clients)))


def topn_mask(scores: torch.Tensor, valid: torch.Tensor,
              n_select: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask, order) of the top-``n_select`` valid entries of the last axis.

    ``order`` sorts by (descending masked score, ascending client index):
    invalid entries are masked to ``NEG_INF`` and the sort is stable over the
    index-ordered input, which is the reference's tie-break."""
    masked = torch.where(valid, scores, NEG_INF)
    order = torch.argsort(-masked, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)      # the inverse permutation
    chosen = (ranks < n_select) & valid
    return chosen.to(torch.float32), order.to(torch.int32)


def topk_by_score(scores: torch.Tensor, ids: torch.Tensor,
                  valid: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``k`` best of a candidate set of (score, global client id,
    validity) triples along the last axis, in :func:`topn_mask`'s order:
    descending masked score, then ascending id, invalid entries masked to
    ``NEG_INF``.  The pair is a total order over distinct ids, so merging
    candidate sets through this function in any grouping gives the dense
    ``order[:k]`` over all of them.

    The reference's two-key sort is two stable sorts here, by id and then by
    −masked score; −0.0 and +0.0 compare equal in both and resolve by id.
    Returns (masked scores, ids int32, valid bool), each (…, k).  Carries
    are padded with (NEG_INF, num_clients, False) sentinels, whose id sorts
    after every real client."""
    masked = torch.where(valid, scores, NEG_INF).to(torch.float32)
    ids = ids.to(torch.int32)
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    neg = torch.gather(-masked, -1, by_id)
    perm = torch.gather(by_id, -1,
                        torch.sort(neg, dim=-1, stable=True).indices)[..., :k]
    return (torch.gather(masked, -1, perm), torch.gather(ids, -1, perm),
            torch.gather(valid.to(torch.bool), -1, perm))


def _clamped(n_select: int, hists: torch.Tensor) -> int:
    """A top-n strategy's budget: n_select clamped to the population."""
    return min(int(n_select), hists.shape[-2])


def _topn(scores, valid, hists, n_select) -> SelectionResult:
    mask, order = topn_mask(scores, valid, n_select)
    return SelectionResult(mask, scores, order,
                           budget=_clamped(n_select, hists))


def _nonempty(hists: torch.Tensor) -> torch.Tensor:
    return class_sum(hists) > 0


def select_random(key: torch.Tensor, hists: torch.Tensor,
                  n_select: int) -> SelectionResult:
    """Uniform without replacement among clients with data: the top n of
    ``uniform(key, (N,))``, the reference's draw bit for bit."""
    scores = rng.uniform(rng.as_key(key, hists.device), (hists.shape[-2],))
    return _topn(scores, _nonempty(hists), hists, n_select)


def select_labelwise(key, hists, n_select) -> SelectionResult:
    return _topn(label_variance_normed(hists), label_variance(hists) > 0,
                 hists, n_select)


def select_labelwise_unnorm(key, hists, n_select) -> SelectionResult:
    scores = label_variance(hists)
    return _topn(scores, scores > 0, hists, n_select)


def select_coverage(key, hists, n_select) -> SelectionResult:
    return _topn(selection_priority(hists), label_variance(hists) > 0,
                 hists, n_select)


def select_kl(key, hists, n_select) -> SelectionResult:
    return _topn(uniformity_score(hists), _nonempty(hists), hists, n_select)


def select_entropy(key, hists, n_select) -> SelectionResult:
    """Shannon entropy of p(L_i): coverage first, balance second."""
    p = empirical_pdf(hists)
    scores = -class_dot(p, log(torch.clamp(p, min=1e-30)))
    return _topn(scores, _nonempty(hists), hists, n_select)


def select_labelwise_priority(key, hists, n_select) -> SelectionResult:
    """§IV-A/B area priority through the area index: rank by −A_p with the
    σ²/n tie-break inside an area, gated by σ² ≠ 0."""
    c = hists.shape[-1]
    p = area_index(hists, None).to(torch.float32)
    scores = -p * (4.0 * c * c) + label_variance_normed(hists)
    return _topn(scores, label_variance(hists) > 0, hists, n_select)


def select_full(key, hists, n_select) -> SelectionResult:
    """Every client with data; the budget is the whole population."""
    valid = _nonempty(hists).to(torch.float32)
    order = torch.argsort(-valid, dim=-1, stable=True).to(torch.int32)
    return SelectionResult(valid, valid, order, budget=hists.shape[-2])


SelectFn = Callable[[Optional[torch.Tensor], torch.Tensor, int],
                    SelectionResult]

# Name -> callable, mutated only through register_strategy.
STRATEGIES: Dict[str, SelectFn] = {}
# Append-only registration order: position is the strategy's id.
_REGISTRY_ORDER: List[str] = []


def register_strategy(name: str, fn: SelectFn, *,
                      overwrite: bool = False,
                      check: bool = False) -> SelectFn:
    """Register ``fn`` under ``name``.  A new name gets the next id;
    re-registering (``overwrite=True``) swaps the callable and keeps the id.
    ``check=True``, the contract pass over ``fn``, is not ported yet and
    raises."""
    if check:
        raise NotImplementedError(
            "register_strategy(check=True), the contract pass over a "
            "strategy, is not ported yet (ROADMAP Queue 1 item 16)")
    if not name or not isinstance(name, str):
        raise ValueError(f"strategy name must be a non-empty str; got {name!r}")
    if name in STRATEGIES and not overwrite:
        raise ValueError(
            f"strategy {name!r} is already registered (id {strategy_id(name)});"
            " pass overwrite=True to replace its callable (the id is kept)")
    if not callable(fn):
        raise TypeError(f"strategy {name!r} must be callable; got {type(fn)}")
    STRATEGIES[name] = fn
    if name not in _REGISTRY_ORDER:
        _REGISTRY_ORDER.append(name)
    return fn


def registered_strategies() -> Tuple[str, ...]:
    return tuple(_REGISTRY_ORDER)


def strategy_id(name: str) -> int:
    try:
        return _REGISTRY_ORDER.index(name)
    except ValueError:
        raise KeyError(f"unknown strategy {name!r}; have "
                       f"{registered_strategies()}") from None


def get_strategy(name: str) -> SelectFn:
    try:
        return STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown selection strategy {name!r}; have "
                       f"{sorted(STRATEGIES)}") from None


BUILTIN_STRATEGIES: Tuple[str, ...] = (
    "random", "labelwise", "labelwise_unnorm", "coverage", "kl", "entropy",
    "full")
for _name, _fn in zip(BUILTIN_STRATEGIES,
                      (select_random, select_labelwise,
                       select_labelwise_unnorm, select_coverage, select_kl,
                       select_entropy, select_full)):
    register_strategy(_name, _fn)
del _name, _fn
register_strategy("labelwise_priority", select_labelwise_priority)
