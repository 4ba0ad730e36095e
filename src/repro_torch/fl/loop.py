"""FL training-loop front-end: ``run_fl`` (a thin shim over
``fl.experiment.run``) and the host-driven loop ``run_fl_host``, rounds ×
(materialize -> select -> train -> aggregate -> evaluate), one round function
call per round.

Keys follow the reference's tree exactly (``repro_torch.rng``, bit-equal to
JAX's): ``key = PRNGKey(seed)``, init from ``fold_in(key, 1)``, round t's
``kt = fold_in(key, 1000 + t)``, its data from ``fold_in(kt, 0)`` and its
selection from ``fold_in(kt, 1)``; the eval set draws from ``PRNGKey(999)``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import plan_round
from ..core.ordered import class_dot
from ..data import client_batches
from .. import rng
from ..device import resolve_device
from ..obs import make_collector, resolve_metrics, resolve_telemetry_request
from .client import batched_eval
from .round import (check_adversary, make_fl_round, resolve_adversary,
                    resolve_aggregator, stack_global_params)
from .workloads import Workload, get_workload


@dataclasses.dataclass
class FLHistory:
    """One trial's trajectories and its wall-clock seconds.  For a clustered
    family ``accuracy``/``loss`` are the mixture of the per-cluster models
    weighted by each cluster's valid clients, and ``cluster_accuracy`` /
    ``cluster_loss`` (rounds × M) and ``cluster_assign`` (rounds × N) hold
    the detail.  ``telemetry`` maps each collected metric to its (rounds, …)
    series.  ``compile_s`` is the time spent compiling ahead of the rounds,
    kept out of ``wall_s``: the port compiles nothing ahead (its kernels
    build once per source hash, at their first launch), so its engines
    report 0."""
    accuracy: List[float]
    loss: List[float]
    num_selected: List[float]
    wall_s: float
    cluster_accuracy: Optional[List[List[float]]] = None
    cluster_loss: Optional[List[List[float]]] = None
    cluster_assign: Optional[List[List[int]]] = None
    compile_s: float = 0.0
    telemetry: Optional[Dict[str, Any]] = None

    @property
    def final_accuracy(self) -> float:
        return self.accuracy[-1]

    def summary(self) -> Dict[str, float]:
        return {"final_accuracy": self.accuracy[-1],
                "final_loss": self.loss[-1],
                "rounds": len(self.accuracy), "wall_s": self.wall_s}


def run_fl(plan: np.ndarray, fl_cfg, *, strategy: Optional[str] = None,
           aggregation: Optional[str] = None, rounds: Optional[int] = None,
           ds=None, seed: Optional[int] = None, verbose: bool = False,
           engine: str = "sim", avail: Optional[np.ndarray] = None,
           eval_n_per_class: int = 50, workload: str = "cnn",
           device: "str | torch.device | None" = None) -> FLHistory:
    """Run FL over a non-IID label plan through the engine registry, as the
    reference's ``run_fl``: the plan becomes one explicit-plan
    ``ScenarioSpec`` and ``engine`` picks the runner ("sim", the batched
    grid engine; "host", :func:`run_fl_host`)."""
    from . import experiment
    scenario = experiment.ScenarioSpec.from_plan("scenario", plan,
                                                 avail=avail)
    spec = experiment.ExperimentSpec(
        scenarios=(scenario,), strategies=(strategy or fl_cfg.selection,),
        seeds=(fl_cfg.seed if seed is None else seed,), engine=engine,
        fl=fl_cfg, aggregation=aggregation, rounds=rounds,
        eval_n_per_class=eval_n_per_class, workload=workload)
    res = experiment.run(spec, ds=ds, device=device)
    traj = res.trajectory(scenario.name, spec.strategies[0], spec.seeds[0])
    cl = res.cluster_trajectories()
    c_kw = {} if cl is None else {
        "cluster_accuracy": cl["accuracy"][0, 0, 0].tolist(),
        "cluster_loss": cl["loss"][0, 0, 0].tolist(),
        "cluster_assign": cl["assign"][0, 0, 0].tolist()}
    hist = FLHistory([float(a) for a in traj["accuracy"]],
                     [float(x) for x in traj["loss"]],
                     [float(x) for x in traj["num_selected"]],
                     res.wall_s + res.compile_s, **c_kw)
    if verbose:
        for t, (a, x, n) in enumerate(zip(hist.accuracy, hist.loss,
                                          hist.num_selected)):
            print(f"  round {t + 1:3d}/{len(hist.accuracy)}: acc={a:.4f} "
                  f"loss={x:.4f} selected={n:.0f}")
    return hist


def telemetry_keys(clustered: bool) -> List[str]:
    """The round-state keys the ``sim`` and ``host`` engines can offer."""
    keys = ["hists", "mask", "num_classes", "params_old", "params_new"]
    if clustered:
        return keys + ["assign", "n_clusters", "centroids", "prev_centroids"]
    return keys + ["client_update_norms"]


class RoundTelemetry:
    """The requested round metrics of T trials, shared by both engines.

    ``telemetry`` names metrics (or ``("auto",)``), resolved against the
    round state the engines offer (:func:`telemetry_keys`, or ``keys``
    for another engine, with its static ints in ``statics``).  :meth:`add`
    takes one round's state with a leading trial axis and collects it one
    trial at a time (a metric's contract has no trial axis); the previous
    round's centroids (zeros in round 0) are kept here.  ``needs_norms``
    says whether the engine must compute the per-client update norms."""

    def __init__(self, telemetry: Sequence[str], agg,
                 keys: Optional[Sequence[str]] = None,
                 statics: Optional[Dict[str, int]] = None):
        self.metrics = resolve_metrics(
            resolve_telemetry_request(telemetry),
            telemetry_keys(agg.clustered) if keys is None else keys)
        self.needs_norms = not agg.clustered and any(
            "client_update_norms" in m.requires for m in self.metrics)
        self.statics = {"n_clusters": agg.n_clusters, **(statics or {})}
        self.collector = self.prev_cent = None
        self.series: Dict[str, List[np.ndarray]] = {}

    def add(self, hists: torch.Tensor, mask: torch.Tensor,
            params_old: Dict[str, torch.Tensor],
            params_new: Dict[str, torch.Tensor], *,
            norms: Optional[torch.Tensor] = None,
            assign: Optional[torch.Tensor] = None,
            centroids: Optional[torch.Tensor] = None,
            extra: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """One round: hists (T, N, C), mask (T, N), params leaves (T, …),
        norms (T, N) when ``needs_norms``, a clustered family's assign
        (T, N) and centroids (T, M, C), and any other state key the engine
        offers in ``extra``, each (T, …)."""
        if self.collector is None:
            self.collector = make_collector(self.metrics, {
                "num_classes": int(hists.shape[-1]), **self.statics})
            if centroids is not None:
                self.prev_cent = torch.zeros_like(centroids)
        rows = []
        for i in range(hists.shape[0]):
            dyn = {"hists": hists[i], "mask": mask[i],
                   "params_old": {k: p[i] for k, p in params_old.items()},
                   "params_new": {k: p[i] for k, p in params_new.items()}}
            if norms is not None:
                dyn["client_update_norms"] = norms[i]
            dyn.update({k: v[i] for k, v in (extra or {}).items()})
            if centroids is not None:
                dyn.update(assign=assign[i], centroids=centroids[i],
                           prev_centroids=self.prev_cent[i])
            rows.append(self.collector(dyn))
        self.prev_cent = centroids
        for name in rows[0]:
            self.series.setdefault(name, []).append(
                torch.stack([r[name] for r in rows]).cpu().numpy())

    def result(self) -> Optional[Dict[str, np.ndarray]]:
        """Each collected metric's (T, rounds, …) series, or None."""
        return {n: np.stack(v, 1) for n, v in self.series.items()} or None


def cluster_mixture(values: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """Σ_c v_c·w_c / max(Σ_c w_c, 1) over the last axis: per-cluster eval
    results mixed by each cluster's valid population, the products summed as
    one left-to-right fused multiply-add chain as the reference's CPU code
    does."""
    tot = torch.clamp(weights.sum(-1), min=1.0)
    return class_dot(values, weights) / tot


def run_fl_host(plan: np.ndarray, fl_cfg, *, strategy: Optional[str] = None,
                aggregation: Optional[str] = None,
                rounds: Optional[int] = None, ds=None,
                seed: Optional[int] = None, verbose: bool = False,
                eval_n_per_class: int = 50,
                workload: "str | Workload" = "cnn",
                telemetry: Sequence[str] = (),
                adversary: Optional[dict] = None,
                adv: Optional[np.ndarray] = None,
                device: "str | torch.device | None" = None) -> FLHistory:
    """Run FL over a non-IID label plan (T, N, n_max) on ``device``
    (``None`` means ``"cuda"``), one round function call a round.  Returns
    the per-round accuracy, loss and number of selected clients.

    A clustered family carries M models (every cluster starts from the same
    init) and evaluates each of them a round.  ``adversary`` with its (N,)
    byzantine mask ``adv`` turns on the engine-level behaviors: byzantine
    clients poison their reports and/or train from the global of τ rounds
    ago, kept in a window of the last τ + 1 globals.  ``telemetry`` names
    round metrics (or ``("auto",)``), collected into
    ``FLHistory.telemetry`` as (rounds, …) series."""
    agg = resolve_aggregator(aggregation, fl_cfg)
    poison_scale, tau = resolve_adversary(adversary)
    check_adversary(agg, poison_scale, tau)
    attacked = poison_scale is not None or tau > 0
    if attacked and adv is None:
        raise ValueError("adversary behaviors requested but no (N,) adv "
                         "byzantine mask passed")
    device = resolve_device(device)
    wl = get_workload(workload)
    if ds is None:
        ds = wl.make_dataset(device)
    elif torch.device(ds.device) != device:
        raise ValueError(f"dataset lives on {ds.device}, run asked for "
                         f"{device}")
    seed = fl_cfg.seed if seed is None else seed
    rounds = fl_cfg.global_epochs if rounds is None else rounds
    tel = RoundTelemetry(telemetry, agg)

    key = rng.PRNGKey(seed, device)
    params = wl.init(rng.fold_in(key, 1), ds)
    if agg.clustered:
        params = stack_global_params(params, agg.n_clusters)
    fl_round = make_fl_round(wl.make_loss(ds), fl_cfg, strategy, agg,
                             poison_scale=poison_scale, with_stale=tau > 0,
                             want_client_norms=tel.needs_norms)
    eval_batch = wl.eval_set(ds, eval_n_per_class)
    eval_fn = wl.make_eval(ds)
    if agg.clustered:
        eval_fn = batched_eval(eval_fn)
    adv_dev = (torch.as_tensor(np.asarray(adv), dtype=torch.float32,
                               device=device) if attacked else None)
    # θ_{t−τ} .. θ_t: [0] is a stale client's training base (θ₀ while the
    # run is younger than τ rounds).
    past = deque([params], maxlen=tau + 1) if tau else None

    acc, losses, nsel = [], [], []
    c_acc, c_loss, c_assign = [], [], []
    t0 = time.time()
    for t in range(rounds):
        kt = rng.fold_in(key, 1000 + t)
        data = wl.materialize(ds, plan_round(plan, t), rng.fold_in(kt, 0))
        batches = client_batches(data, fl_cfg.batch_size, wl.batch_keys)
        params_old = params
        params, info = fl_round(params, batches, data["hists"],
                                rng.fold_in(kt, 1), adv_dev,
                                past[0] if tau else None)
        if tau:
            past.append(params)
        with torch.no_grad():
            loss, m = eval_fn(params, eval_batch)
        if agg.clustered:
            w = info["cluster_weights"]
            c_acc.append(m["accuracy"].tolist())
            c_loss.append(loss.tolist())
            c_assign.append(info["cluster_assign"].tolist())
            loss = cluster_mixture(loss, w)
            m = {"accuracy": cluster_mixture(m["accuracy"], w)}
        ns, ms = float(info["num_selected"]), float(info["mask_sum"])
        if ns != ms:
            raise AssertionError(
                f"round {t}: selection budget violated — trained {ns} "
                f"clients but mask selects {ms}; a strategy's mask escaped "
                "its budget window")
        if tel.metrics:
            extra = {k: None if v is None else v[None] for k, v in (
                ("norms", info.get("client_update_norms")),
                ("assign", info.get("cluster_assign")),
                ("centroids", info.get("cluster_centroids")))}
            tel.add(data["hists"][None], info["mask"][None],
                    {k: p[None] for k, p in params_old.items()},
                    {k: p[None] for k, p in params.items()}, **extra)
        acc.append(float(m["accuracy"]))
        losses.append(float(loss))
        nsel.append(ns)
        if verbose:
            print(f"  round {t + 1:3d}/{rounds}: acc={acc[-1]:.4f} "
                  f"loss={losses[-1]:.4f} selected={nsel[-1]:.0f}")
    wall = time.time() - t0
    series = tel.result()
    return FLHistory(acc, losses, nsel, wall,
                     cluster_accuracy=c_acc if agg.clustered else None,
                     cluster_loss=c_loss if agg.clustered else None,
                     cluster_assign=c_assign if agg.clustered else None,
                     telemetry=None if series is None else
                     {n: v[0] for n, v in series.items()})


def success_rate(histories: List[FLHistory], threshold: float = 0.2) -> float:
    """Paper Table II: the fraction of trials whose final accuracy exceeds
    ``threshold``."""
    return float(np.mean([h.final_accuracy > threshold for h in histories]))
