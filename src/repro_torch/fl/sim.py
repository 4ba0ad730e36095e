"""The batched grid engine: every trial of a grid (cases × strategies ×
seeds) in one round loop, with an explicit trial axis.

The reference compiles one trial as a ``lax.scan`` and ``jax.vmap``s it over
the grid (``repro.fl.sim.make_trial_fn``).  ``torch.func.vmap`` cannot batch
the hand-written kernels (ctypes launches), so here every tensor of the
round carries a leading trial axis T instead, and the loop over rounds stays
on the host.  Each round, for all T trials at once:

1. the round's label plans -> histograms of all T·N clients in one
   ``label_hist`` launch; a (T, N) availability mask zeroes the histograms
   of dark clients (applied once, as in the reference);
2. selection with the reference's universe rule: every strategy of the
   requested universe is computed for every trial and each trial's result
   gathered by its strategy index; the static budget B is the universe's
   widest; the mask is gated on ``hists.sum(-1) > 0``;
3. a clustered family's k-means over all T trials' histograms;
4. images drawn for the selected rows only (``rng``'s counter offsets keep
   them bit-equal to the reference's whole-population draw);
5. local training of all T·B clients as one flattened client axis
   (``round.client_updates``), each from its own start model (its trial's
   global, its cluster's model, or for a ``stale_update`` client the
   global of τ rounds ago), split into equal chunks of whole trials only
   where the card's free memory cannot hold them at once;
6. ``round.server_update``: the FedAvg/FedSGD reduction of all trials in
   one ``weighted_agg`` launch (one a cluster for a clustered family), or
   one call of a robust reducer, then the server step and the count = 0
   guard a trial (and cluster);
7. eval of the T global models (T·M for a clustered family) in one call;
8. the requested round metrics, a trial at a time.

Keys follow the reference's fold_in tree per trial (``PRNGKey(seed)``, init
``fold_in(key, 1)``, round ``kt = fold_in(key, 1000 + t)``, data
``fold_in(kt, 0)``, selection ``fold_in(kt, 1)``), so a trial's selections
equal the host loop's and its trajectory differs only by the training
kernels' summation order over a larger batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .. import rng
from ..core import (STRATEGIES, cluster_counts, kmeans_cluster,
                    selection_budget, strategy_id)
from ..data import client_batches
from ..device import resolve_device
from ..optim import get_optimizer
from .client import batched_eval
from .loop import RoundTelemetry, cluster_mixture
from .round import (check_adversary, client_updates, resolve_adversary,
                    resolve_aggregator, server_update, stack_global_params,
                    start_models)
from .workloads import Workload, get_workload

Params = Dict[str, torch.Tensor]

# Share of the card's memory the training chunks may fill.  Each round's
# phases run under ``torch.profiler`` ranges ``grid/<phase>`` (hists, select,
# kmeans, draw, train, aggregate, eval, metrics), which
# scripts/torch_fl_profile.py reads.
_MEMORY_SHARE = 0.85


@dataclasses.dataclass
class GridResult:
    """Stacked trajectories of one grid, leading axes (cases, strategies,
    seeds), then rounds.  A clustered family's ``accuracy``/``loss`` are the
    mixture over its models (weighted by each cluster's valid clients), and
    ``cluster_accuracy``/``cluster_loss`` (…, rounds, M) and
    ``cluster_assign`` (…, rounds, N) hold the detail.  ``telemetry`` maps
    each collected metric to its (…, rounds, …) series.  ``meta`` holds the
    run's trial count, budget, training chunk, per-round wall times and peak
    device memory."""
    accuracy: np.ndarray
    loss: np.ndarray
    num_selected: np.ndarray
    wall_s: float
    compile_s: float = 0.0
    cluster_accuracy: Optional[np.ndarray] = None
    cluster_loss: Optional[np.ndarray] = None
    cluster_assign: Optional[np.ndarray] = None
    telemetry: Optional[Dict[str, np.ndarray]] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def select_grid(key: torch.Tensor, hists: torch.Tensor, n_sel: int,
                universe: Sequence[str], sid: torch.Tensor):
    """Every trial's selection -> (mask, order, budget).

    hists (T, N, C), key (T, 2), sid (T,) an index into ``universe`` (not a
    global strategy id).  Each strategy of the universe is computed for all
    trials and a trial takes its own strategy's result, as the reference's
    ``_select`` does; ``budget`` is the widest of the universe's static
    budgets, so narrower strategies' extra slots are dead (mask 0)."""
    n_clients = hists.shape[-2]
    rs = [STRATEGIES[name](key, hists, n_sel) for name in universe]
    budget = max(selection_budget(r, n_sel, n_clients) for r in rs)
    if len(rs) == 1:
        return rs[0].mask, rs[0].order, budget
    trial = torch.arange(hists.shape[0], device=hists.device)
    mask = torch.stack([r.mask for r in rs])[sid, trial]
    order = torch.stack([r.order for r in rs])[sid, trial]
    return mask, order, budget


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (T, N, …), idx (T, B) -> (T, B, …)."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + x.shape[2:])


def _chunk_trials(device: torch.device, per_trial: Optional[int],
                  trials: int) -> int:
    """Trials a training call takes: all of them on the CPU; on a card,
    the trials split into the fewest equal chunks that ``_MEMORY_SHARE`` of
    it holds beside what is allocated now, at ``per_trial`` bytes each."""
    if device.type != "cuda" or per_trial is None:
        return trials
    total = torch.cuda.get_device_properties(device).total_memory
    room = _MEMORY_SHARE * total - torch.cuda.memory_allocated(device)
    fit = int(max(1, min(trials, room // max(per_trial, 1))))
    chunks = -(-trials // fit)
    return -(-trials // chunks)


class GridRun:
    """One grid's state between rounds: build it, call :meth:`round` for
    t = 0, 1, … (each returns that round's selection, for inspection), then
    :meth:`result`.  :func:`grid_arrays` is the whole run; a profiler or a
    check can drive the rounds itself.

    plans: (K, T, N, n) int32 (−1 pad), or (K, R, T, N, n) with a plan a
    seed; avail: optional (K, T_a, N) float masks; adv: the (R, N) per-seed
    byzantine masks that ``adversary``'s behaviors need.  Trials are ordered
    (case, strategy, seed)."""

    def __init__(self, plans: np.ndarray, fl_cfg, *,
                 strategies: Sequence[str], seeds: Sequence[int],
                 aggregation: Optional[str] = None,
                 rounds: Optional[int] = None, ds=None,
                 avail: Optional[np.ndarray] = None,
                 eval_n_per_class: int = 50,
                 workload: "str | Workload" = "cnn",
                 telemetry: Sequence[str] = (),
                 adversary: Optional[dict] = None,
                 adv: Optional[np.ndarray] = None,
                 device: "str | torch.device | None" = None):
        self.device = device = resolve_device(device)
        self.wl = wl = get_workload(workload)
        self.ds = ds = wl.make_dataset(device) if ds is None else ds
        self.agg = agg = resolve_aggregator(aggregation, fl_cfg)
        self.poison_scale, self.tau = resolve_adversary(adversary)
        check_adversary(agg, self.poison_scale, self.tau)
        attacked = self.poison_scale is not None or self.tau > 0
        self.universe = tuple(strategies)
        for name in self.universe:
            strategy_id(name)
        seeds = [int(s) for s in seeds]
        plans = np.asarray(plans, np.int32)
        if plans.ndim not in (4, 5):
            raise ValueError(f"plans must be (K[, R], T, N, n); got "
                             f"{plans.shape}")
        per_seed = plans.ndim == 5
        if per_seed and plans.shape[1] != len(seeds):
            raise ValueError(f"per-seed plans axis 1 ({plans.shape[1]}) must "
                             f"match len(seeds) ({len(seeds)})")
        self.fl_cfg = fl_cfg
        self.shape = (plans.shape[0], len(self.universe), len(seeds))
        self.num_rounds = fl_cfg.global_epochs if rounds is None else rounds
        # Trial t = (k, s, r) in row-major order.
        ks, ss, rs = (a.ravel() for a in np.meshgrid(
            *(np.arange(n) for n in self.shape), indexing="ij"))
        self.trials = trials = ks.size
        self.plans = torch.from_numpy(
            plans.reshape((-1,) + plans.shape[-3:])).to(device)
        self.plan_idx = torch.from_numpy(
            ks * self.shape[2] + rs if per_seed else ks).to(device)
        self.sid = torch.from_numpy(ss).to(device)
        self.avail = self.avail_idx = None
        if avail is not None:
            self.avail = torch.from_numpy(
                np.asarray(avail, np.float32)).to(device)
            self.avail_idx = torch.from_numpy(ks).to(device)
        self.adv = None
        if attacked:
            if adv is None:
                raise ValueError("adversary behaviors requested but no "
                                 "(R, N) adv byzantine masks passed")
            adv = np.asarray(adv, np.float32)
            if adv.ndim != 2 or adv.shape[0] != len(seeds):
                raise ValueError(f"adv must be (len(seeds), N); got "
                                 f"{adv.shape}")
            self.adv = torch.from_numpy(adv[rs]).to(device)      # (T, N)
        self.key = rng.PRNGKey(torch.tensor([seeds[r] for r in rs]), device)
        params = wl.init(rng.fold_in(self.key, 1), ds)          # (T, …)
        self.ring = None
        if self.tau:
            # Slot j holds the newest θ_t' with t' ≡ j (mod τ + 1); every
            # slot starts at θ₀, so a read before round τ sees the init.
            self.ring = stack_global_params(params, self.tau + 1, axis=1)
        if agg.clustered:
            params = stack_global_params(params, agg.n_clusters, axis=1)
        self.params = params
        self.loss_fn = wl.make_loss(ds)
        self.eval_batch = wl.eval_set(ds, eval_n_per_class)
        self.eval_fn = batched_eval(wl.make_eval(ds))
        self.opt = get_optimizer(fl_cfg.optimizer, fl_cfg.lr)
        self.tel = RoundTelemetry(telemetry, agg)
        self.chunk = self.per_trial = None
        self.budget = None
        cols = (trials, self.num_rounds)
        self.acc, self.loss, self.nsel, self.msum = (
            np.zeros(cols, np.float32) for _ in range(4))
        self.cluster = None
        if agg.clustered:
            m_c = agg.n_clusters
            n = plans.shape[-2]
            self.cluster = {
                "accuracy": np.zeros(cols + (m_c,), np.float32),
                "loss": np.zeros(cols + (m_c,), np.float32),
                "assign": np.zeros(cols + (n,), np.int32)}
        self.round_s = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)

    def round(self, t: int) -> Dict[str, torch.Tensor]:
        """Run round t for every trial; returns its ``hists`` (T, N, C),
        ``mask`` (T, N), ``selected`` (T, B) and ``live`` (T, B), and for a
        clustered family ``assign`` (T, N) and ``centroids`` (T, M, C)."""
        t0 = time.perf_counter()
        wl, ds, cfg, trials = self.wl, self.ds, self.fl_cfg, self.trials
        agg = self.agg
        kt = rng.fold_in(self.key, 1000 + t)
        with record_function("grid/hists"):
            data = wl.hists(ds, self.plans[self.plan_idx,
                                           t % self.plans.shape[1]])
            hists = data["hists"]
            if self.avail is not None:
                hists = hists * self.avail[
                    self.avail_idx, t % self.avail.shape[1]][..., None]
        with record_function("grid/select"):
            mask, order, budget = select_grid(
                rng.fold_in(kt, 1), hists, cfg.clients_per_round,
                self.universe, self.sid)
            mask = mask * (hists.sum(-1) > 0)
            idx = order[:, :budget].long()
            live = torch.gather(mask, 1, idx)
            labels = _gather_rows(data["labels"], idx)
        out = {"hists": hists, "mask": mask, "selected": idx, "live": live}
        assign_sel = None
        if agg.clustered:
            with record_function("grid/kmeans"):
                assign, cent = kmeans_cluster(hists, agg.n_clusters,
                                              n_iters=agg.kmeans_iters)
                assign_sel = torch.gather(assign, 1, idx)
            out.update(assign=assign, centroids=cent)
        with record_function("grid/draw"):
            sel = {**wl.sample(ds, rng.fold_in(kt, 0), data["labels"], idx),
                   "labels": labels, "valid": labels >= 0}
            batches = client_batches({k: _flat(v) for k, v in sel.items()},
                                     cfg.batch_size, wl.batch_keys)
            del sel
        sizes = (labels >= 0).sum(-1).to(torch.float32)
        adv_sel = (None if self.adv is None
                   else torch.gather(self.adv, 1, idx))          # (T, B)
        stale = None
        if self.tau:
            # Write θ_t into its slot first (τ = 0 then reads the current
            # params), then read θ_{t−τ} (θ₀ before round τ).
            for k, p in self.params.items():
                self.ring[k][:, t % (self.tau + 1)] = p
            stale = {k: r[:, (t - self.tau) % (self.tau + 1)]
                     for k, r in self.ring.items()}
        params_old = self.params
        with record_function("grid/train"):
            updates, norms = self._updates(batches, budget, assign_sel,
                                           adv_sel, stale)
        del batches
        with record_function("grid/aggregate"):
            self.params = server_update(
                self.params, {k: u.reshape((trials, budget) + u.shape[1:])
                              for k, u in updates.items()},
                live, sizes, cfg, agg, assign=assign_sel)
        del updates
        with record_function("grid/eval"), torch.no_grad():
            if agg.clustered:
                m_c = agg.n_clusters
                loss_c, m = self.eval_fn(
                    {k: p.reshape((-1,) + p.shape[2:])
                     for k, p in self.params.items()}, self.eval_batch)
                loss_c = loss_c.reshape(trials, m_c)
                acc_c = m["accuracy"].reshape(trials, m_c)
                w = cluster_counts(assign, m_c,
                                   weights=(hists.sum(-1) > 0).to(
                                       torch.float32))
                loss, acc = cluster_mixture(loss_c, w), cluster_mixture(
                    acc_c, w)
                for name, x in (("accuracy", acc_c), ("loss", loss_c),
                                ("assign", assign)):
                    self.cluster[name][:, t] = x.cpu().numpy()
            else:
                loss, m = self.eval_fn(self.params, self.eval_batch)
                acc = m["accuracy"]
        for col, x in ((self.acc, acc), (self.loss, loss),
                       (self.nsel, live.sum(-1)), (self.msum, mask.sum(-1))):
            col[:, t] = x.cpu().numpy()
        if self.tel.metrics:
            with record_function("grid/metrics"):
                full = None
                if norms is not None:
                    full = torch.zeros(hists.shape[:2], dtype=torch.float32,
                                       device=hists.device).scatter(
                        1, idx, norms * live)
                self.tel.add(hists, mask, params_old, self.params,
                             norms=full, assign=out.get("assign"),
                             centroids=out.get("centroids"))
        self.budget = budget
        self.round_s.append(time.perf_counter() - t0)
        return out

    def _start(self, part: slice, budget: int, assign_sel, adv_sel,
               stale) -> Params:
        """:func:`round.start_models` of the trials in ``part``."""
        def cut(x):
            return None if x is None else x[part]
        return start_models(
            {k: p[part] for k, p in self.params.items()}, budget,
            assign_sel=cut(assign_sel), adv_sel=cut(adv_sel),
            stale=None if stale is None else {k: v[part]
                                              for k, v in stale.items()})

    def _updates(self, batches: Dict[str, torch.Tensor], budget: int,
                 assign_sel, adv_sel, stale):
        """Every trial's client updates, leaves (T·B, …), and the (T, B)
        as-reported update norms when a metric asks; ``self.chunk`` trials a
        ``client_updates`` call (fixed in round 0)."""
        if self.chunk is None:
            self.chunk = self._size_chunk(batches, budget, assign_sel,
                                          adv_sel, stale)
        parts, norms = [], []
        for a in range(0, self.trials, self.chunk):
            b = min(a + self.chunk, self.trials)
            ups, m = client_updates(
                self._start(slice(a, b), budget, assign_sel, adv_sel, stale),
                {k: v[a * budget:b * budget] for k, v in batches.items()},
                self.loss_fn, self.opt, self.fl_cfg, self.agg,
                adv=None if adv_sel is None else adv_sel[a:b].reshape(-1),
                poison_scale=self.poison_scale, want_norms=self.tel.needs_norms)
            parts.append(ups)
            if self.tel.needs_norms:
                norms.append(m["update_norm"])
        norm = (torch.cat(norms).reshape(self.trials, budget)
                if norms else None)
        if len(parts) == 1:
            return parts[0], norm
        return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}, norm

    def _size_chunk(self, batches: Dict[str, torch.Tensor], budget: int,
                    assign_sel, adv_sel, stale) -> int:
        """On a card, the memory a trial's training takes, from one local
        epoch of two minibatches of trial 0's clients (the result is thrown
        away), then :func:`_chunk_trials`."""
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            client_updates(
                self._start(slice(0, 1), budget, assign_sel, adv_sel, stale),
                {k: v[:budget, :2] for k, v in batches.items()},
                self.loss_fn, self.opt,
                dataclasses.replace(self.fl_cfg, local_epochs=1), self.agg,
                adv=None if adv_sel is None else adv_sel[0],
                poison_scale=self.poison_scale, want_norms=self.tel.needs_norms)
            torch.cuda.synchronize(dev)
            self.per_trial = torch.cuda.max_memory_allocated(dev) - base
        return _chunk_trials(dev, self.per_trial, self.trials)

    def result(self, wall_s: float) -> GridResult:
        if not np.array_equal(self.nsel, self.msum):
            raise AssertionError(
                "selection budget violated: clients trained per round "
                f"{self.nsel.tolist()} != mask.sum() {self.msum.tolist()}; a "
                "strategy's mask escaped its declared budget window")
        shape = self.shape + (self.num_rounds,)
        meta = {"trials": self.trials, "budget": self.budget,
                "chunk_trials": self.chunk,
                "per_trial_bytes": self.per_trial, "round_s": self.round_s}
        if self.device.type == "cuda":
            meta["peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        extra = {}
        if self.cluster is not None:
            extra = {f"cluster_{k}": v.reshape(shape + v.shape[2:])
                     for k, v in self.cluster.items()}
        tel = self.tel.result()
        if tel is not None:
            # (T, rounds, …) -> (K, S, R, rounds, …)
            tel = {n: v.reshape(shape + v.shape[2:]) for n, v in tel.items()}
        return GridResult(self.acc.reshape(shape), self.loss.reshape(shape),
                          self.nsel.reshape(shape), wall_s=wall_s,
                          telemetry=tel, meta=meta, **extra)


def grid_arrays(plans: np.ndarray, fl_cfg, **kw) -> GridResult:
    """Run the whole grid (the ``"sim"`` engine's body): :class:`GridRun`'s
    arguments; the result's leading axes are (K, len(strategies),
    len(seeds)), then rounds."""
    run = GridRun(plans, fl_cfg, **kw)
    t0 = time.perf_counter()
    for t in range(run.num_rounds):
        run.round(t)
    return run.result(time.perf_counter() - t0)


def simulate(plan: np.ndarray, fl_cfg, *, strategy: Optional[str] = None,
             seed: Optional[int] = None, avail: Optional[np.ndarray] = None,
             adv: Optional[np.ndarray] = None, **kw) -> GridResult:
    """One trial through the grid engine: a (T, N, n) plan, one strategy
    and one seed (``adv`` its (N,) byzantine mask); trajectories with no
    leading axes."""
    res = grid_arrays(
        np.asarray(plan)[None], fl_cfg,
        strategies=(strategy or fl_cfg.selection,),
        seeds=(fl_cfg.seed if seed is None else seed,),
        avail=None if avail is None else np.asarray(avail)[None],
        adv=None if adv is None else np.asarray(adv)[None], **kw)
    cell = {name: getattr(res, name)[0, 0, 0] for name in (
        "accuracy", "loss", "num_selected", "cluster_accuracy",
        "cluster_loss", "cluster_assign") if getattr(res, name) is not None}
    tel = (None if res.telemetry is None else
           {n: v[0, 0, 0] for n, v in res.telemetry.items()})
    return dataclasses.replace(res, telemetry=tel, **cell)


def run_grid(plans: np.ndarray, fl_cfg, *, strategies: Sequence[str],
             seeds: Sequence[int], aggregation: Optional[str] = None,
             rounds: Optional[int] = None, ds=None,
             avail: Optional[np.ndarray] = None, eval_n_per_class: int = 50,
             workload: str = "cnn",
             device: "str | torch.device | None" = None) -> GridResult:
    """The whole grid through ``experiment.run`` (engine ``"sim"``), as the
    reference's ``run_grid``: plans (K, T, N, n) or (K, R, T, N, n), one
    explicit-plan scenario a case; avail (T, N) or (K, T, N)."""
    from . import experiment
    plans = np.asarray(plans)
    if plans.ndim not in (4, 5):
        raise ValueError(f"plans must be (K[, R], T, N, n); got {plans.shape}")
    if avail is not None and np.asarray(avail).ndim == 2:
        avail = np.broadcast_to(np.asarray(avail)[None],
                                (plans.shape[0],) + np.asarray(avail).shape)
    scenarios = tuple(experiment.ScenarioSpec.from_plan(
        f"case{k}", plans[k], avail=None if avail is None else avail[k])
        for k in range(plans.shape[0]))
    spec = experiment.ExperimentSpec(
        scenarios=scenarios, strategies=tuple(strategies),
        seeds=tuple(seeds), engine="sim", fl=fl_cfg, aggregation=aggregation,
        rounds=rounds, eval_n_per_class=eval_n_per_class, workload=workload)
    res = experiment.run(spec, ds=ds, device=device)
    cl = res.cluster_trajectories()
    extra = {} if cl is None else {"cluster_accuracy": cl["accuracy"],
                                   "cluster_loss": cl["loss"],
                                   "cluster_assign": cl["assign"]}
    return GridResult(res.accuracy, res.loss, res.num_selected,
                      wall_s=res.wall_s, meta=res.meta.get("sim", {}),
                      **extra)


def stack_case_plans(cases: Sequence[str], fl_cfg, *, seed0: int = 0,
                     rounds: Optional[int] = None,
                     samples_per_client: Optional[int] = None,
                     majority: Optional[int] = None,
                     num_classes: int = 10) -> np.ndarray:
    """(K, T, N, n) stacked §III case plans sharing one shape."""
    from ..core import SAMPLES_PER_CLIENT, case_label_plan
    spc = samples_per_client or SAMPLES_PER_CLIENT
    maj = majority if majority is not None else int(spc * 200 / 290)
    t = fl_cfg.global_epochs if rounds is None else rounds
    return np.stack([
        case_label_plan(c, seed=seed0, num_rounds=t,
                        num_clients=fl_cfg.num_clients,
                        num_classes=num_classes, samples_per_client=spc,
                        majority=maj)
        for c in cases])
