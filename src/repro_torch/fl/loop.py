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
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import plan_round
from ..data import client_batches
from .. import rng
from ..device import resolve_device
from .round import make_fl_round, resolve_aggregator
from .workloads import Workload, get_workload


@dataclasses.dataclass
class FLHistory:
    """One trial's trajectories and its wall-clock seconds.  ``compile_s``
    is the time spent compiling ahead of the rounds, kept out of
    ``wall_s``: the port compiles nothing ahead (its kernels build once per
    source hash, at their first launch), so its engines report 0."""
    accuracy: List[float]
    loss: List[float]
    num_selected: List[float]
    wall_s: float
    compile_s: float = 0.0

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
    hist = FLHistory([float(a) for a in traj["accuracy"]],
                     [float(x) for x in traj["loss"]],
                     [float(x) for x in traj["num_selected"]],
                     res.wall_s + res.compile_s)
    if verbose:
        for t, (a, x, n) in enumerate(zip(hist.accuracy, hist.loss,
                                          hist.num_selected)):
            print(f"  round {t + 1:3d}/{len(hist.accuracy)}: acc={a:.4f} "
                  f"loss={x:.4f} selected={n:.0f}")
    return hist


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
    (``None`` means ``"cuda"``).  Returns the per-round accuracy, loss and
    number of selected clients.

    Clustered aggregators, ``reduce`` overrides, adversaries and telemetry
    are not ported yet and raise."""
    agg = resolve_aggregator(aggregation, fl_cfg)
    if agg.clustered or agg.reduce is not None:
        raise NotImplementedError(
            "clustered aggregation and reduce overrides are not ported yet")
    if adversary or adv is not None:
        raise NotImplementedError("adversary behaviors are not ported yet")
    if telemetry:
        raise NotImplementedError("telemetry is not ported yet")
    device = resolve_device(device)
    wl = get_workload(workload)
    if ds is None:
        ds = wl.make_dataset(device)
    elif torch.device(ds.device) != device:
        raise ValueError(f"dataset lives on {ds.device}, run asked for "
                         f"{device}")
    seed = fl_cfg.seed if seed is None else seed
    rounds = fl_cfg.global_epochs if rounds is None else rounds

    key = rng.PRNGKey(seed, device)
    params = wl.init(rng.fold_in(key, 1), ds)
    fl_round = make_fl_round(wl.make_loss(ds), fl_cfg, strategy, agg)
    eval_batch = wl.eval_set(ds, eval_n_per_class)
    eval_fn = wl.make_eval(ds)

    acc, losses, nsel = [], [], []
    t0 = time.time()
    for t in range(rounds):
        kt = rng.fold_in(key, 1000 + t)
        data = wl.materialize(ds, plan_round(plan, t), rng.fold_in(kt, 0))
        batches = client_batches(data, fl_cfg.batch_size, wl.batch_keys)
        params, info = fl_round(params, batches, data["hists"],
                                rng.fold_in(kt, 1))
        with torch.no_grad():
            loss, m = eval_fn(params, eval_batch)
        ns, ms = float(info["num_selected"]), float(info["mask_sum"])
        if ns != ms:
            raise AssertionError(
                f"round {t}: selection budget violated — trained {ns} "
                f"clients but mask selects {ms}; a strategy's mask escaped "
                "its budget window")
        acc.append(float(m["accuracy"]))
        losses.append(float(loss))
        nsel.append(ns)
        if verbose:
            print(f"  round {t + 1:3d}/{rounds}: acc={acc[-1]:.4f} "
                  f"loss={losses[-1]:.4f} selected={nsel[-1]:.0f}")
    return FLHistory(acc, losses, nsel, time.time() - t0)
