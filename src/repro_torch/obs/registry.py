"""Round metrics registry: the observability counterpart of the strategy,
workload and aggregator registries (mirrors ``repro.obs.registry``).

A *metric* observes one engine round of one trial: ``fn(round_state) ->``
a scalar or small tensor, in torch ops.  ``round_state`` is a dict the
engine assembles per round; every entry is a tensor or a static int:

==================  =======================================================
``hists``           (N, C) float32 label histograms, availability applied
``mask``            (N,) float32 0/1 selection mask after the validity gate
``num_classes``     static int C
``params_old``      the global params entering the round
``params_new``      the params leaving it (clustered families: the (M, …)
                    stacked tree)
``assign``          (N,) int32 round k-means assignment  (clustered only)
``n_clusters``      static int M                         (clustered only)
``centroids``       (M, C) round k-means centroids       (clustered only)
``prev_centroids``  (M, C) the previous round's centroids, zeros in round 0
``staleness_delays`` (K,) int32 staleness of each buffered arrival
                    (async only)
``tau_max``         static int                           (async only)
``client_update_norms`` (N,) float32 ℓ₂ norm of each client's as-reported
                    update (post-poison), zero for clients that did not
                    train (single-model families; computed only when a
                    resolved metric asks)
==================  =======================================================

A metric declares ``requires``, the state keys it reads; an engine collects
exactly the requested metrics whose requirements it can satisfy.  The
engines compute the norms and keep the previous centroids only when a
resolved metric asks, and a metric only reads, so a run with telemetry off
is bit-identical to one with it on.  Registration follows the strategy
registry's contract: append-only stable ids, ``overwrite=True`` keeps the id.

Metrics are requested per experiment by ``ExperimentSpec.telemetry`` (names,
or ``("auto",)`` for every metric the engine can satisfy) or by the
``REPRO_TELEMETRY`` environment variable (``1``/``all``/``auto``, a comma
list of names, or ``0``/``off``; the spec's field wins when non-empty).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import torch

ENV_TELEMETRY = "REPRO_TELEMETRY"

# Base result axes every series shares; a metric's own trailing axes append.
BASE_AXES = ("scenario", "strategy", "seed", "round")


@dataclasses.dataclass(frozen=True)
class Metric:
    """One registered round metric: ``fn(round_state) -> Tensor`` over the
    state entries named in ``requires``; ``axes`` labels the trailing dims
    of its result (``()`` for a scalar)."""
    name: str
    fn: Callable[[Mapping[str, Any]], torch.Tensor]
    requires: Tuple[str, ...] = ()
    axes: Tuple[str, ...] = ()


_METRICS: Dict[str, Metric] = {}
_METRIC_IDS: list = []          # append-only ledger: position = stable id


def register_metric(name: str, fn: Callable, *, requires: Sequence[str] = (),
                    axes: Sequence[str] = (), overwrite: bool = False,
                    check: bool = False, device=None) -> Metric:
    """Register a round metric under ``name``.  Ids are append-only
    (``overwrite=True`` replaces the callable and keeps the id).
    ``check=True`` raises ``repro_torch.analysis.ContractError`` if the fn
    violates the metric contract (untraceable, oversized output, host
    round trips), traced on ``device`` (``None``: the card)."""
    if not name or not isinstance(name, str):
        raise ValueError(f"metric name must be a non-empty str; got {name!r}")
    if name in _METRICS and not overwrite:
        raise ValueError(f"metric {name!r} already registered")
    if not callable(fn):
        raise TypeError(f"metric {name!r} must be callable; got {type(fn)}")
    m = Metric(name=name, fn=fn, requires=tuple(requires), axes=tuple(axes))
    if check:
        from ..analysis import assert_metric_contract
        assert_metric_contract(name, m, device=device)
    _METRICS[name] = m
    if name not in _METRIC_IDS:
        _METRIC_IDS.append(name)
    return m


def registered_metrics() -> Tuple[str, ...]:
    """Registered metric names in stable-id order."""
    return tuple(_METRIC_IDS)


def metric_id(name: str) -> int:
    """The append-only stable id of ``name`` (position in the ledger)."""
    try:
        return _METRIC_IDS.index(name)
    except ValueError:
        raise KeyError(f"unknown metric {name!r}; have "
                       f"{registered_metrics()}") from None


def get_metric(name: str) -> Metric:
    if name not in _METRICS:
        raise KeyError(f"unknown metric {name!r}; have "
                       f"{registered_metrics()}")
    return _METRICS[name]


def metrics_registry() -> Dict[str, Metric]:
    """Live name → Metric view (the analysis layer iterates it)."""
    return _METRICS


def resolve_telemetry_request(spec_telemetry: Sequence[str] = ()
                              ) -> Tuple[str, ...]:
    """The effective metric request: the spec's own ``telemetry`` when
    non-empty, else ``REPRO_TELEMETRY`` (``0``/``off``/unset -> none;
    ``1``/``on``/``all``/``auto`` -> every applicable metric; otherwise a
    comma list of names)."""
    if spec_telemetry:
        return tuple(spec_telemetry)
    raw = os.environ.get(ENV_TELEMETRY, "").strip()
    if not raw or raw.lower() in ("0", "off", "false", "none"):
        return ()
    if raw.lower() in ("1", "on", "all", "auto", "true"):
        return ("auto",)
    return tuple(n.strip() for n in raw.split(",") if n.strip())


def resolve_metrics(names: Sequence[str], available: Sequence[str]
                    ) -> Tuple[Metric, ...]:
    """The metrics an engine collects: the requested ``names`` (``"auto"``
    expands to every registered metric) whose ``requires`` the engine's
    ``available`` state keys satisfy.  Unknown names raise; a known metric
    the engine cannot satisfy (``staleness_hist`` on ``sim``) is skipped."""
    avail = set(available)
    want: list = []
    for n in names:
        if n == "auto":
            for reg in _METRIC_IDS:
                if reg not in want:
                    want.append(reg)
        elif n not in want:
            get_metric(n)
            want.append(n)
    return tuple(m for m in (get_metric(n) for n in want)
                 if set(m.requires) <= avail)


def collect_metrics(metrics: Sequence[Metric], state: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """Evaluate ``metrics`` over one round's state -> name -> float32."""
    with torch.no_grad():
        return {m.name: torch.as_tensor(m.fn(state)).to(torch.float32)
                for m in metrics}


def make_collector(metrics: Sequence[Metric],
                   static_state: Mapping[str, Any] = ()) -> Callable:
    """A collector with the statics (num_classes, n_clusters, tau_max) in
    its closure, so the per-round state holds only tensors."""
    statics = dict(static_state or {})
    metrics = tuple(metrics)

    def collect(dyn: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return collect_metrics(metrics, {**statics, **dyn})

    return collect


# ---------------------------------------------------------------------------
# Builtin metrics (stable ids 0..6, the reference's)
# ---------------------------------------------------------------------------

def _selected_label_hist(state: Mapping[str, Any]) -> torch.Tensor:
    """(C,) pooled label counts over the selected clients."""
    return (state["hists"] * state["mask"][:, None]).sum(0)


def _selection_entropy(state: Mapping[str, Any]) -> torch.Tensor:
    """Shannon entropy (nats) of the selected set's pooled label pdf: 0 when
    nothing is selected, falling toward 0 as the selection concentrates."""
    h = _selected_label_hist(state)
    p = h / torch.clamp(h.sum(), min=1e-9)
    return -(p * torch.log(torch.clamp(p, min=1e-12))).sum()


def _update_norm(state: Mapping[str, Any]) -> torch.Tensor:
    """‖Δθ‖₂ of the global model over every leaf (clustered families: over
    the whole stacked tree)."""
    new, old = state["params_new"], state["params_old"]
    return torch.sqrt(sum(((new[k].to(torch.float32)
                            - old[k].to(torch.float32)) ** 2).sum()
                          for k in new))


def _cluster_occupancy(state: Mapping[str, Any]) -> torch.Tensor:
    """(M,) valid clients in each k-means cluster; a persistent zero is the
    starved cluster the report flags."""
    assign, m = state["assign"], state["n_clusters"]
    valid = (state["hists"].sum(-1) > 0).to(torch.float32)
    ids = torch.arange(m, device=assign.device)[:, None]
    return ((assign[None, :] == ids).to(torch.float32) * valid[None]).sum(-1)


def _centroid_drift(state: Mapping[str, Any]) -> torch.Tensor:
    """Mean L2 distance between this round's and the previous round's
    centroids (round 0 measures from zeros)."""
    d = state["centroids"] - state["prev_centroids"]
    return torch.sqrt((d ** 2).sum(-1)).mean()


def _staleness_hist(state: Mapping[str, Any]) -> torch.Tensor:
    """(tau_max + 1,) buffered arrivals at each staleness level."""
    tau = state["staleness_delays"]
    w = int(state["tau_max"]) + 1
    levels = torch.arange(w, dtype=tau.dtype, device=tau.device)
    return (tau[:, None] == levels[None, :]).to(torch.float32).sum(0)


def _delta_outlier(state: Mapping[str, Any]) -> torch.Tensor:
    """(N,) z-score of each selected client's as-reported update norm
    against the round's selected set (0 for the others, and for a round
    whose norms are all equal): a poisoned or stale report stands |z| σ off."""
    norms, m = state["client_update_norms"], state["mask"]
    cnt = torch.clamp(m.sum(), min=1.0)
    mean = (norms * m).sum() / cnt
    var = (((norms - mean) ** 2) * m).sum() / cnt
    return (norms - mean) / torch.sqrt(var + 1e-12) * m


register_metric("selection_entropy", _selection_entropy,
                requires=("hists", "mask"))
register_metric("selected_label_hist", _selected_label_hist,
                requires=("hists", "mask"), axes=("class",))
register_metric("update_norm", _update_norm,
                requires=("params_old", "params_new"))
register_metric("cluster_occupancy", _cluster_occupancy,
                requires=("hists", "assign", "n_clusters"), axes=("cluster",))
register_metric("centroid_drift", _centroid_drift,
                requires=("centroids", "prev_centroids"))
register_metric("staleness_hist", _staleness_hist,
                requires=("staleness_delays", "tau_max"), axes=("staleness",))
register_metric("delta_outlier", _delta_outlier,
                requires=("client_update_norms", "mask"), axes=("client",))
