"""Population-scale FL: the two-tier ``hier`` engine, the ``async`` FedBuff
engine and the population-scale round (mirrors ``repro.fl.population``).

E edge aggregators each own an N/E-client block.  Three layers:

* **Block-streamed selection** (:func:`streamed_selection`): each block's
  (Bs, C) histograms are formed from its labels, scored by the registered
  strategy with ``n_select = block_size`` (so the mask is the strategy's
  validity gate), gated on a non-empty histogram, and merged into a running
  top-``budget`` carry through :func:`~repro_torch.core.selection.
  topk_by_score`, beside the block-reducible label statistics.  The dense
  (N, C) matrix never exists.  The block fixes what a step means (the key
  ``fold_in(key, b)`` that ``random`` draws from, the block ids of the
  two-tier sum), not how many launches it takes: the order of
  ``topk_by_score`` is total and the statistics are integer sums, so a
  chunk of blocks is scored in one ``label_hist`` launch and merged at once,
  bit-equal to the reference's block-by-block scan (at the paper's width
  all ten blocks of a round go in one chunk; at population scale chunks of
  ``_CHUNK_ROWS`` clients keep memory flat in N).
* **``hier``**: per round, streamed selection (labels only), then local
  training of only the selected ``budget`` clients and the two-tier
  reduction ``Σ_e Σ_{i∈e} w·x / Σ_e Σ_{i∈e} w``
  (:func:`~repro_torch.core.aggregation.two_tier_weighted_mean`), a
  reassociation of flat FedAvg/FedSGD.  Images are ``sim``'s draw under
  ``fold_in(kt, 0)``, hashed only for the selected rows.
* **``async``** (FedBuff, Nguyen et al.): the server buffers K
  staleness-tagged block arrivals a window and keeps a ring of the last
  ``tau_max + 1`` versions; arrival j trains its block's locally selected
  clients from the version τ_j windows old and enters the buffer with
  weight ``n_e·(1 + τ_j)^(−α)``, summed in arrival order; the buffer's
  weighted mean is applied after the K-th.  Every arrival of a window trains
  from a ring entry fixed when the window starts, so the K arrivals train
  in one call, each slot from its own start model, and their K means take
  one ``weighted_agg`` launch on its trial axis.  The schedule comes from
  the availability transform (:func:`derive_arrival_schedule`).
* **:func:`make_population_round`**: the 10⁵–10⁶-client round over a
  procedural plan (``plan_fn(key, ids)``), with only the selected
  clients' payload drawn (:func:`~repro_torch.fl.workloads.
  materialize_rows`), so memory stays flat in N.

Engine knobs ride in ``ExperimentSpec.engine_options``: ``num_blocks``
(both), ``buffer_k``/``alpha``/``tau_max`` (async).  Both engines reject
clustered families, a custom ``reduce`` and strategies that are not
block-separable (the classifier of ``repro_torch.analysis.separability``,
over the strategy's aten graph).  Trials run one at a time, as the
reference's ``_run_cells`` runs them.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import rng
from ..core import (STRATEGIES, get_aggregator, interpolate,
                    merge_label_statistics, partial_label_statistics,
                    selection_budget, topk_by_score, two_tier_weighted_mean)
from ..core.ordered import fma
from ..core.selection import NEG_INF
from ..data import client_batches
from ..device import resolve_device
from ..kernels.dispatch import client_histograms, masked_weighted_mean
from ..obs import record_memory_analysis
from ..optim import get_optimizer
from .client import local_train
from .loop import RoundTelemetry
from .round import client_updates, server_step, start_models
from .workloads import Workload, get_workload, materialize_rows

Params = Dict[str, torch.Tensor]

# Clients a chunk of :func:`streamed_selection` scores at once (whole
# blocks; at least one block).
_CHUNK_ROWS = 1 << 16

# Override denylist: names here are rejected by the block engines without
# consulting the classifier (labelwise_priority's area index offsets every
# score by the population-wide label-union count, which differs per block —
# the classifier agrees, but the pin keeps the error message stable and the
# rejection classifier-independent).
NON_BLOCK_SEPARABLE = frozenset({"labelwise_priority"})

# Opt-out allowlist: extension-strategy names whose authors vouch for block
# separability, skipping the classification — for row-wise strategies whose
# graph defeats the static pass (an opaque op on the scores' path).
ASSUME_BLOCK_SEPARABLE: set = set()

# (name, id(fn), num_classes) -> SeparabilityVerdict.  id(fn) keys the cache
# to the registered callable, so overwrite-registrations re-classify.
_SEPARABILITY_CACHE: Dict[Tuple[str, int, int], Any] = {}


def _block_separability(strategy: str, num_classes: int, device=None):
    fn = STRATEGIES[strategy]
    key = (strategy, id(fn), int(num_classes))
    if key not in _SEPARABILITY_CACHE:
        from ..analysis.separability import classify_strategy
        _SEPARABILITY_CACHE[key] = classify_strategy(
            fn, num_clients=32, num_classes=int(num_classes), name=strategy,
            device=device)
    return _SEPARABILITY_CACHE[key]


def _check_block_separable(strategy: str, engine: str, num_classes: int,
                           device=None) -> None:
    """Refuse ``strategy`` unless its scores are a row-wise function of the
    client's own histogram row — the denylist first, then the vouched-for
    names, then the classifier's verdict over the strategy's aten graph
    (``repro_torch.analysis.separability``, its mask probe on ``device``;
    cached per (name, callable, num_classes))."""
    if strategy in NON_BLOCK_SEPARABLE:
        raise ValueError(
            f"strategy {strategy!r} is not block-separable (its score "
            "depends on population-wide statistics, not just the client's "
            f"own histogram) and cannot run on engine={engine!r}; use "
            "'coverage' (identical ordering, row-wise scores) or run on "
            "engine='sim'")
    if strategy in ASSUME_BLOCK_SEPARABLE or strategy not in STRATEGIES:
        return  # vouched for / unknown name (raises later at get_strategy)
    verdict = _block_separability(strategy, num_classes, device)
    if not verdict.separable:
        why = "; ".join(verdict.reasons) or verdict.summary()
        raise ValueError(
            f"strategy {strategy!r} is not block-separable per the graph "
            f"classification ({why}) and cannot run on engine={engine!r}; "
            "run it on engine='sim' or 'host', or add the name to "
            "repro_torch.fl.population.ASSUME_BLOCK_SEPARABLE to vouch for "
            "it")


def default_num_blocks(num_clients: int) -> int:
    """The largest divisor of N that is ≤ ⌊√N⌋: ≈√N blocks of ≈√N."""
    cap = max(1, math.isqrt(num_clients))
    return max(d for d in range(1, cap + 1) if num_clients % d == 0)


def _check_block_engine(agg, strategies: Sequence[str], engine: str,
                        num_classes: int, device=None) -> None:
    if agg.clustered:
        raise ValueError(
            f"engine={engine!r} aggregates through the two-tier block "
            "reduction; clustered families (per-cluster global models) are "
            "not supported — run them on engine='sim' or 'host'")
    if agg.reduce is not None:
        raise ValueError(
            f"engine={engine!r} aggregates through the two-tier block "
            "reduction; a custom Aggregator.reduce override is not "
            "supported — run it on engine='sim' or 'host'")
    for s in strategies:
        _check_block_separable(s, engine, num_classes, device)


def _resolve_blocks(num_clients: int, options: Dict[str, Any]
                    ) -> Tuple[int, int]:
    """(num_blocks, block_size) from engine_options, validated."""
    e = int(options.get("num_blocks", default_num_blocks(num_clients)))
    if e < 1 or num_clients % e:
        raise ValueError(
            f"num_blocks ({e}) must be a positive divisor of num_clients "
            f"({num_clients}) — every edge aggregator owns an equal block")
    return e, num_clients // e


def _static_budget(strategy: str, num_clients: int, num_classes: int,
                   n_select: int) -> int:
    """The strategy's static gather width, from one call on a zero
    histogram matrix on the CPU (every builtin's budget is a shape fact)."""
    r = STRATEGIES[strategy](rng.PRNGKey(0),
                             torch.zeros((num_clients, num_classes)),
                             n_select)
    return selection_budget(r, n_select, num_clients)


# ---------------------------------------------------------------------------
# Block-streamed selection
# ---------------------------------------------------------------------------

def streamed_selection(labels_for_blocks: Callable[[torch.Tensor,
                                                    torch.Tensor],
                                                   torch.Tensor],
                       avail_for_blocks: Optional[Callable[[torch.Tensor],
                                                           torch.Tensor]],
                       *, num_blocks: int, block_size: int, num_classes: int,
                       strategy: str, key: torch.Tensor, budget: int,
                       chunk_blocks: Optional[int] = None):
    """The global top-``budget`` selection over client blocks.

    ``labels_for_blocks(blocks, ids)`` gives the label rows (nb, block_size,
    n) of the blocks ``blocks`` (nb,) whose global client ids are ``ids``
    (nb, block_size); ``avail_for_blocks(blocks)`` their (nb, block_size)
    availability, or None for all available.  Blocks go ``chunk_blocks`` at
    a time (default: ``_CHUNK_ROWS`` clients): one ``label_hist`` launch and
    one strategy call a chunk, each block scored under ``fold_in(key, b)``.
    A chunk's steps run under the profiler ranges ``select/labels``,
    ``select/hists``, ``select/score`` and ``select/merge``.

    Returns ``(ids, live, scores, stats)``: the (budget,) int32 client ids
    in dense ``topn_mask`` order, their live flags and masked scores, and
    the merged :func:`partial_label_statistics`, bit-equal to the
    reference's scan over single blocks for any ``chunk_blocks``."""
    select = STRATEGIES[strategy]
    dev = key.device
    if chunk_blocks is None:
        chunk_blocks = max(1, _CHUNK_ROWS // block_size)
    n_clients = num_blocks * block_size
    top_s = torch.full((budget,), NEG_INF, dtype=torch.float32, device=dev)
    top_i = torch.full((budget,), n_clients, dtype=torch.int32, device=dev)
    top_v = torch.zeros((budget,), dtype=torch.bool, device=dev)
    stats = {"hist_sum": torch.zeros(num_classes, device=dev),
             "n_valid": torch.zeros((), device=dev),
             "present": torch.zeros(num_classes, dtype=torch.bool,
                                    device=dev)}
    within = torch.arange(block_size, dtype=torch.int32, device=dev)
    for b0 in range(0, num_blocks, chunk_blocks):
        blocks = torch.arange(b0, min(b0 + chunk_blocks, num_blocks),
                              dtype=torch.int32, device=dev)
        ids = blocks[:, None] * block_size + within
        with record_function("select/labels"):
            labels = labels_for_blocks(blocks, ids).to(torch.int32)
        with record_function("select/hists"):
            valid = labels >= 0
            hists = client_histograms(torch.where(valid, labels, 0),
                                      num_classes, valid)
            if avail_for_blocks is not None:
                hists = hists * avail_for_blocks(blocks)[..., None]
        with record_function("select/score"):
            r = select(rng.fold_in(key, blocks), hists, block_size)
            live = (r.mask > 0) & (hists.sum(-1) > 0)
        with record_function("select/merge"):
            top_s, top_i, top_v = topk_by_score(
                torch.cat([top_s, r.scores.to(torch.float32).reshape(-1)]),
                torch.cat([top_i, ids.reshape(-1)]),
                torch.cat([top_v, live.reshape(-1)]), budget)
            stats = merge_label_statistics(stats, partial_label_statistics(
                hists.reshape(-1, num_classes)))
    return top_i, top_v, top_s, stats


def _dense_mask(n_clients: int, ids: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """The (N,) selection mask from selected ids and their live flags; a
    sentinel id (≥ N) is dropped, as the reference's out-of-bounds scatter
    drops it."""
    keep = ids < n_clients
    return torch.zeros(n_clients, dtype=torch.float32,
                       device=live.device).index_add_(
        0, ids[keep].long(), live.to(torch.float32)[keep])


def _stack_trial(tree: Params) -> Params:
    return {k: v[None] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Hierarchical two-tier engine (engine="hier")
# ---------------------------------------------------------------------------

def make_hier_trial_fn(fl_cfg, ds=None, *, strategy: str,
                       aggregation: Optional[str] = None,
                       rounds: Optional[int] = None,
                       eval_n_per_class: int = 50,
                       workload: "str | Workload" = "cnn",
                       num_blocks: Optional[int] = None,
                       telemetry: Sequence[str] = (),
                       device: "str | torch.device | None" = None):
    """Build ``trial(plan, seed, avail=None) -> dict``: one hierarchical FL
    trial on ``device`` (None means ``"cuda"``), with ``sim``'s key tree.

    Per round: :func:`streamed_selection` over the resident plan's blocks
    (one ``label_hist`` launch at the paper's width), the selected rows'
    images from ``sim``'s draw, local training of the ``budget`` selected
    clients and the two-tier reduction (a plain float64 product: no
    ``weighted_agg`` launch), then the server step with the count = 0
    guard.  The returned dict holds (rounds,) ``accuracy``, ``loss``,
    ``num_selected`` and ``round_s`` (each round's wall seconds, ending
    where its results reach the host), the (rounds, budget) ``selected`` ids
    and ``live`` flags, and ``telemetry`` ({name: (rounds, …)} or None)."""
    wl = get_workload(workload)
    dev = resolve_device(device) if ds is None else torch.device(ds.device)
    ds = wl.make_dataset(dev) if ds is None else ds
    agg = get_aggregator(aggregation or fl_cfg.aggregation)
    n_clients = fl_cfg.num_clients
    n_classes = wl.num_classes(ds)
    _check_block_engine(agg, (strategy,), "hier", n_classes, dev)
    e_blocks, block_size = _resolve_blocks(
        n_clients, {} if num_blocks is None else {"num_blocks": num_blocks})
    budget = _static_budget(strategy, n_clients, n_classes,
                            fl_cfg.clients_per_round)
    num_rounds = fl_cfg.global_epochs if rounds is None else rounds
    opt = get_optimizer(fl_cfg.optimizer, fl_cfg.lr)
    loss_fn = wl.make_loss(ds)
    eval_batch = wl.eval_set(ds, eval_n_per_class)
    eval_fn = wl.make_eval(ds)
    keys = ("hists", "mask", "num_classes", "params_old", "params_new")

    def trial(plan, seed: int, avail=None) -> Dict[str, Any]:
        plan = torch.as_tensor(np.asarray(plan, np.int32), device=dev)
        avail = (None if avail is None else torch.as_tensor(
            np.asarray(avail, np.float32), device=dev))
        tel = RoundTelemetry(telemetry, agg, keys=keys)
        key = rng.PRNGKey(int(seed), dev)
        params = wl.init(rng.fold_in(key, 1), ds)
        out = {k: [] for k in ("accuracy", "loss", "num_selected",
                               "selected", "live", "round_s")}
        for t in range(num_rounds):
            t0 = time.perf_counter()
            kt = rng.fold_in(key, 1000 + t)
            plan_t = plan[t % plan.shape[0]]
            avail_t = None if avail is None else avail[t % avail.shape[0]]
            blocks_view = plan_t.reshape(e_blocks, block_size, -1)
            ids, live_b, _, _ = streamed_selection(
                lambda blocks, _ids: blocks_view[blocks.long()],
                None if avail_t is None else
                lambda blocks: avail_t.reshape(e_blocks, block_size)[
                    blocks.long()],
                num_blocks=e_blocks, block_size=block_size,
                num_classes=n_classes, strategy=strategy,
                key=rng.fold_in(kt, 1), budget=budget)
            idx = ids.long()
            live = live_b.to(torch.float32)
            labels = plan_t[idx]
            sel = {**wl.sample(ds, rng.fold_in(kt, 0), plan_t, idx),
                   "labels": labels, "valid": labels >= 0}
            batches = client_batches(sel, fl_cfg.batch_size, wl.batch_keys)
            del sel
            sizes = (labels >= 0).sum(-1).to(torch.float32)
            ups, _ = client_updates(start_models(_stack_trial(params), budget),
                                    batches, loss_fn, opt, fl_cfg, agg)
            del batches
            red = two_tier_weighted_mean(ups, live, sizes, idx // block_size,
                                         e_blocks)
            params_old = params
            params = {k: v[0] for k, v in server_step(
                _stack_trial(params), _stack_trial(red), live[None], fl_cfg,
                agg).items()}
            with torch.no_grad():
                ev_loss, ev_m = eval_fn(params, eval_batch)
            if tel.metrics:
                hists = wl.hists(ds, plan_t)["hists"]
                if avail_t is not None:
                    hists = hists * avail_t[:, None]
                tel.add(hists[None], _dense_mask(n_clients, ids, live)[None],
                        _stack_trial(params_old), _stack_trial(params))
            n_live = float(live.sum())
            for name, v in (("accuracy", float(ev_m["accuracy"])),
                            ("loss", float(ev_loss)),
                            ("num_selected", n_live),
                            ("selected", idx.cpu().numpy()),
                            ("live", live.cpu().numpy()),
                            ("round_s", time.perf_counter() - t0)):
                out[name].append(v)
        res = {k: np.asarray(v) for k, v in out.items()}
        series = tel.result()
        res["telemetry"] = (None if series is None else
                            {n: v[0] for n, v in series.items()})
        return res

    trial.budget = budget
    trial.num_blocks = e_blocks
    trial.block_size = block_size
    return trial


# ---------------------------------------------------------------------------
# Async FedBuff engine (engine="async")
# ---------------------------------------------------------------------------

def staleness_weight(tau, alpha: float) -> torch.Tensor:
    """FedBuff's staleness discount ``(1 + τ)^(−α)`` in float32, taken in
    float64 and rounded once; bit-equal to the reference's float32 ``pow``
    at α ∈ {0.5, 1} (tests/test_torch_population.py)."""
    tau = torch.as_tensor(tau)
    return torch.pow(1.0 + tau.to(torch.float64),
                     -float(alpha)).to(torch.float32)


def derive_arrival_schedule(plan: np.ndarray, avail: Optional[np.ndarray],
                            *, rounds: int, num_blocks: int, block_size: int,
                            buffer_k: int, tau_max: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """The deterministic (rounds, K) arrival schedule: ``blocks[t, j]`` the
    block arriving j-th in window t (round-robin, so ``buffer_k =
    num_blocks`` hears every edge once a window) and ``delays[t, j]`` its
    staleness, the block's dark-client fraction scaled to ``tau_max`` and
    rounded.  Mask-mode availability reads the (T_a, N) mask; otherwise
    darkness comes from the plan (a dark client's row is all −1).  No
    availability gives all delays 0."""
    t_idx = np.arange(rounds)
    blocks = (t_idx[:, None] * buffer_k
              + np.arange(buffer_k)[None, :]) % num_blocks
    if tau_max <= 0:
        return blocks.astype(np.int32), np.zeros_like(blocks, np.int32)
    if avail is not None:
        a = np.asarray(avail, np.float32)[t_idx % avail.shape[0]]
    else:
        p = np.asarray(plan)
        p = p[t_idx % p.shape[0]]
        a = 1.0 - (p < 0).all(axis=-1).astype(np.float32)   # (rounds, N)
    dark = 1.0 - a.reshape(rounds, num_blocks, block_size).mean(-1)
    delays = np.rint(tau_max * dark[t_idx[:, None], blocks])
    return (blocks.astype(np.int32),
            np.clip(delays, 0, tau_max).astype(np.int32))


def make_async_trial_fn(fl_cfg, ds=None, *, strategy: str,
                        aggregation: Optional[str] = None,
                        rounds: Optional[int] = None,
                        eval_n_per_class: int = 50,
                        workload: "str | Workload" = "cnn",
                        num_blocks: Optional[int] = None,
                        buffer_k: Optional[int] = None, alpha: float = 0.5,
                        tau_max: int = 2,
                        schedule: Optional[Tuple[np.ndarray,
                                                 np.ndarray]] = None,
                        telemetry: Sequence[str] = (),
                        device: "str | torch.device | None" = None):
    """Build ``trial(plan, seed, avail=None) -> dict``: one async FedBuff
    trial on ``device`` (None means ``"cuda"``), windows overlapping through
    a ring of the last ``tau_max + 1`` versions.

    Window t: the round's histograms (one ``label_hist`` launch); each of
    the K scheduled arrivals selects ``block_budget`` clients of its block
    under ``fold_in(fold_in(kt, 1), j)`` (one strategy call for all K); all
    K·block_budget clients train in one call, arrival j's from the ring
    entry τ_j windows old; the K block means take one ``weighted_agg``
    launch on its trial axis; the buffer sums ``w_j·Δ_j`` in arrival order
    (fused multiply-adds, as the reference's CPU code rounds them) with
    ``w_j = n_live·(1 + τ_j)^(−α)``, and the server applies ``θ + η·Σ wΔ /
    Σ w`` (η the server lr for FedAvg, 1 for FedSGD) unless no arrival had
    a live client.  Returns the dict of :func:`make_hier_trial_fn` without
    ``selected``/``live``.  ``schedule`` is :func:`derive_arrival_schedule`'s
    (blocks, delays)."""
    wl = get_workload(workload)
    dev = resolve_device(device) if ds is None else torch.device(ds.device)
    ds = wl.make_dataset(dev) if ds is None else ds
    agg = get_aggregator(aggregation or fl_cfg.aggregation)
    n_clients = fl_cfg.num_clients
    n_classes = wl.num_classes(ds)
    _check_block_engine(agg, (strategy,), "async", n_classes, dev)
    e_blocks, block_size = _resolve_blocks(
        n_clients, {} if num_blocks is None else {"num_blocks": num_blocks})
    k_buf = e_blocks if buffer_k is None else int(buffer_k)
    if k_buf < 1:
        raise ValueError(f"buffer_k must be >= 1; got {k_buf}")
    if tau_max < 0:
        raise ValueError(f"tau_max must be >= 0; got {tau_max}")
    ring_len = int(tau_max) + 1
    num_rounds = fl_cfg.global_epochs if rounds is None else rounds
    # Each edge asks its own clients_per_round (capped by the block).
    select = STRATEGIES[strategy]
    blk_budget = _static_budget(strategy, block_size, n_classes,
                                min(fl_cfg.clients_per_round, block_size))
    opt = get_optimizer(fl_cfg.optimizer, fl_cfg.lr)
    loss_fn = wl.make_loss(ds)
    eval_batch = wl.eval_set(ds, eval_n_per_class)
    eval_fn = wl.make_eval(ds)
    if schedule is None:
        raise ValueError("make_async_trial_fn needs the host-derived arrival "
                         "schedule (derive_arrival_schedule)")
    sched_blocks = np.asarray(schedule[0], np.int64)
    sched_delays = np.asarray(schedule[1], np.int64)
    if sched_blocks.shape != (num_rounds, k_buf):
        raise ValueError(f"schedule shape {sched_blocks.shape} != "
                         f"(rounds, buffer_k) ({num_rounds}, {k_buf})")
    server_lr = fl_cfg.server_lr if agg.base == "fedavg" else 1.0
    keys = ("hists", "mask", "num_classes", "params_old", "params_new",
            "staleness_delays", "tau_max")
    arrivals = torch.arange(k_buf, device=dev)

    def trial(plan, seed: int, avail=None) -> Dict[str, Any]:
        plan = torch.as_tensor(np.asarray(plan, np.int32), device=dev)
        avail = (None if avail is None else torch.as_tensor(
            np.asarray(avail, np.float32), device=dev))
        tel = RoundTelemetry(telemetry, agg, keys=keys,
                             statics={"tau_max": int(tau_max)})
        key = rng.PRNGKey(int(seed), dev)
        params0 = wl.init(rng.fold_in(key, 1), ds)
        # Every slot starts at θ₀, so a stale read before version τ exists
        # is θ₀.
        ring = [params0] * ring_len
        out = {k: [] for k in ("accuracy", "loss", "num_selected",
                               "round_s")}
        for t in range(num_rounds):
            t0 = time.perf_counter()
            kt = rng.fold_in(key, 1000 + t)
            plan_t = plan[t % plan.shape[0]]
            hists = wl.hists(ds, plan_t)["hists"]
            if avail is not None:
                hists = hists * avail[t % avail.shape[0]][:, None]
            theta_t = ring[t % ring_len]
            blocks_t = torch.from_numpy(sched_blocks[t]).to(dev)
            taus = np.minimum(sched_delays[t], t)
            hists_e = hists.reshape(e_blocks, block_size, -1)[blocks_t]
            r = select(rng.fold_in(rng.fold_in(kt, 1), arrivals), hists_e,
                       blk_budget)
            mask = r.mask * (hists_e.sum(-1) > 0)
            idx_local = r.order[:, :blk_budget].long()
            live = torch.gather(mask, 1, idx_local)               # (K, B)
            idx = (blocks_t[:, None] * block_size + idx_local).reshape(-1)
            labels = plan_t[idx]
            sel = {**wl.sample(ds, rng.fold_in(kt, 0), plan_t, idx),
                   "labels": labels, "valid": labels >= 0}
            batches = client_batches(sel, fl_cfg.batch_size, wl.batch_keys)
            del sel
            sizes = (labels >= 0).sum(-1).to(torch.float32).reshape(
                k_buf, blk_budget)
            stale = {k: torch.stack([ring[(t - int(tau)) % ring_len][k]
                                     for tau in taus])
                     for k in theta_t}                            # (K, …)
            ups, _ = client_updates(start_models(stale, blk_budget), batches,
                                    loss_fn, opt, fl_cfg, agg)
            del batches
            bar = masked_weighted_mean(
                {k: u.reshape((k_buf, blk_budget) + u.shape[1:])
                 for k, u in ups.items()}, live, sizes)           # (K, …)
            del ups
            if agg.base == "fedsgd":
                delta = {k: -fl_cfg.lr * g.to(torch.float32)
                         for k, g in bar.items()}
            else:
                delta = {k: b.to(torch.float32) - stale[k].to(torch.float32)
                         for k, b in bar.items()}
            w = (live * sizes).sum(-1) * staleness_weight(taus, alpha).to(dev)
            buf = {k: torch.zeros_like(d[0]) for k, d in delta.items()}
            den = torch.zeros((), dtype=torch.float32, device=dev)
            for j in range(k_buf):
                buf = {k: fma(w[j], delta[k][j], acc) for k, acc in buf.items()}
                den = den + w[j]
            denom = torch.clamp(den, min=1e-12)
            theta_new = {k: torch.where(
                den > 0, fma(server_lr, buf[k] / denom, p).to(p.dtype), p)
                for k, p in theta_t.items()}
            ring[(t + 1) % ring_len] = theta_new
            with torch.no_grad():
                ev_loss, ev_m = eval_fn(theta_new, eval_batch)
            if tel.metrics:
                sel_mask = torch.zeros(n_clients, dtype=torch.float32,
                                       device=dev).index_add_(
                    0, idx, live.reshape(-1))
                # A block arriving twice in a window adds its live clients
                # twice; the mask is membership, so clamp.
                tel.add(hists[None], torch.clamp(sel_mask, max=1.0)[None],
                        _stack_trial(theta_t), _stack_trial(theta_new),
                        extra={"staleness_delays": torch.from_numpy(
                            taus.astype(np.int32))[None].to(dev)})
            n_live = float(live.sum())
            for name, v in (("accuracy", float(ev_m["accuracy"])),
                            ("loss", float(ev_loss)),
                            ("num_selected", n_live),
                            ("round_s", time.perf_counter() - t0)):
                out[name].append(v)
        res = {k: np.asarray(v) for k, v in out.items()}
        series = tel.result()
        res["telemetry"] = (None if series is None else
                            {n: v[0] for n, v in series.items()})
        return res

    trial.num_blocks = e_blocks
    trial.block_size = block_size
    trial.block_budget = blk_budget
    trial.buffer_k = k_buf
    return trial


# ---------------------------------------------------------------------------
# Engine registry bodies (registered by repro_torch.fl.experiment)
# ---------------------------------------------------------------------------

def _run_cells(spec, lowered, make_trial, engine_label: str, device):
    """Every (scenario, strategy, seed) trial, one at a time -> the
    (K, S, R, rounds) accuracy, loss and num_selected, the wall seconds,
    and the metric series {name: (K, S, R, rounds, …)} or None."""
    k_n, s_n, r_n = len(lowered), len(spec.strategies), len(spec.seeds)
    t_n = spec.num_rounds
    names = ("accuracy", "loss", "num_selected")
    out = {n: np.zeros((k_n, s_n, r_n, t_n), np.float32) for n in names}
    tel: Dict[str, np.ndarray] = {}
    wall = 0.0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for k, low in enumerate(lowered):
        for s, strat in enumerate(spec.strategies):
            trial = make_trial(strat, low)
            for r, seed in enumerate(spec.seeds):
                plan = low.plan[r] if low.per_seed else low.plan
                t0 = time.perf_counter()
                res = trial(plan, seed, low.avail)
                wall += time.perf_counter() - t0
                for n in names:
                    out[n][k, s, r] = res[n]
                for name, v in (res["telemetry"] or {}).items():
                    v = np.asarray(v, np.float32)
                    if name not in tel:
                        tel[name] = np.zeros((k_n, s_n, r_n) + v.shape,
                                             np.float32)
                    tel[name][k, s, r] = v
            record_memory_analysis(f"{engine_label}:{low.name}:{strat}",
                                   device)
    return out, wall, tel or None


def run_engine_hier(spec, lowered, ds, device):
    """The ``engine="hier"`` registry body (:func:`make_hier_trial_fn`)."""
    opts = dict(spec.engine_options or {})
    agg = get_aggregator(spec.aggregation or spec.fl.aggregation)
    _check_block_engine(agg, spec.strategies, "hier",
                        get_workload(spec.workload).num_classes(ds), device)
    e_blocks, block_size = _resolve_blocks(spec.fl.num_clients, opts)
    trials: Dict[str, Any] = {}

    def make_trial(strat, low):
        if strat not in trials:
            trials[strat] = make_hier_trial_fn(
                spec.fl, ds, strategy=strat, aggregation=spec.aggregation,
                rounds=spec.rounds, eval_n_per_class=spec.eval_n_per_class,
                workload=spec.workload, num_blocks=e_blocks,
                telemetry=spec.telemetry)
        return trials[strat]

    out, wall, tel = _run_cells(spec, lowered, make_trial, "hier", device)
    meta = {"population": {
        "mode": "hier", "num_blocks": e_blocks, "block_size": block_size,
        "budgets": {s: t.budget for s, t in trials.items()}}}
    if tel:
        meta["_telemetry_series"] = tel
    return (out["accuracy"], out["loss"], out["num_selected"], wall, 0.0,
            meta)


def run_engine_async(spec, lowered, ds, device):
    """The ``engine="async"`` registry body (:func:`make_async_trial_fn`)."""
    opts = dict(spec.engine_options or {})
    agg = get_aggregator(spec.aggregation or spec.fl.aggregation)
    _check_block_engine(agg, spec.strategies, "async",
                        get_workload(spec.workload).num_classes(ds), device)
    e_blocks, block_size = _resolve_blocks(spec.fl.num_clients, opts)
    k_buf = int(opts.get("buffer_k", e_blocks))
    alpha = float(opts.get("alpha", 0.5))
    tau_max = int(opts.get("tau_max", 2))
    schedules = {}
    for low in lowered:
        plan0 = low.plan[0] if low.per_seed else low.plan
        schedules[low.name] = derive_arrival_schedule(
            plan0, low.avail, rounds=spec.num_rounds, num_blocks=e_blocks,
            block_size=block_size, buffer_k=k_buf, tau_max=tau_max)
    trials: Dict[Tuple[str, str], Any] = {}

    def make_trial(strat, low):
        cell = (strat, low.name)
        if cell not in trials:
            trials[cell] = make_async_trial_fn(
                spec.fl, ds, strategy=strat, aggregation=spec.aggregation,
                rounds=spec.rounds, eval_n_per_class=spec.eval_n_per_class,
                workload=spec.workload, num_blocks=e_blocks, buffer_k=k_buf,
                alpha=alpha, tau_max=tau_max, schedule=schedules[low.name],
                telemetry=spec.telemetry)
        return trials[cell]

    out, wall, tel = _run_cells(spec, lowered, make_trial, "async", device)
    delays = np.stack([schedules[low.name][1] for low in lowered])
    meta = {"population": {
        "mode": "async", "num_blocks": e_blocks, "block_size": block_size,
        "buffer_k": k_buf, "alpha": alpha, "tau_max": tau_max,
        "staleness_weight": "1/(1+tau)^alpha",
        "delay_mean": float(delays.mean()), "delay_max": int(delays.max())}}
    if tel:
        meta["_telemetry_series"] = tel
    return (out["accuracy"], out["loss"], out["num_selected"], wall, 0.0,
            meta)


# ---------------------------------------------------------------------------
# Population-scale round: procedural plans, payload for the selected only
# ---------------------------------------------------------------------------

def synthetic_population_plan(num_classes: int = 10,
                              samples_per_client: int = 8,
                              majority_frac: float = 0.75
                              ) -> Callable[[torch.Tensor, torch.Tensor],
                                            torch.Tensor]:
    """A procedural case1b-like plan, ``plan_fn(key, ids) -> (B, n)``
    int32: client i's row is a function of ``(key, i)`` alone
    (``fold_in(key, i)``), a majority label on ``majority_frac`` of its
    samples and uniform labels on the rest, drawn with
    :func:`~repro_torch.rng.randint` as the reference draws them, for all
    rows of ``ids`` at once."""
    n = samples_per_client
    n_major = int(round(majority_frac * n))

    def plan_fn(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        k = rng.fold_in(key, torch.as_tensor(ids, device=key.device))
        maj = rng.randint(rng.fold_in(k, 0), (), 0, num_classes)
        tail = rng.randint(rng.fold_in(k, 1), (n,), 0, num_classes)
        head = torch.arange(n, device=key.device) < n_major
        return torch.where(head, maj[..., None], tail).to(torch.int32)

    return plan_fn


def make_population_round(*, plan_fn: Callable[[torch.Tensor, torch.Tensor],
                                               torch.Tensor],
                          num_clients: int, block_size: int,
                          strategy: str = "labelwise", budget: int,
                          workload: "str | Workload" = "cnn", ds=None,
                          batch_size: int = 8, local_epochs: int = 1,
                          lr: float = 1e-3, server_lr: float = 1.0,
                          optimizer: str = "sgd",
                          chunk_blocks: Optional[int] = None,
                          device: "str | torch.device | None" = None):
    """One population-scale FedAvg round, ``round(params, key_t) ->
    (new_params, info)``, on ``device`` (None means ``"cuda"``).

    Phase A streams the ``num_clients / block_size`` blocks of the
    procedural plan (``plan_fn(fold_in(key_t, 0), ids)``) through
    :func:`streamed_selection`, ``chunk_blocks`` blocks a ``label_hist``
    launch.  Phase B regenerates only the selected rows' labels, draws
    their payload through :func:`~repro_torch.fl.workloads.
    materialize_rows` under ``fold_in(key_t, 1)``, trains them and reduces
    through the two-tier sum over the edges that own a selected client
    (ranked densely, at most ``budget`` of them).  Peak memory is
    O(chunk + budget·payload), flat in N.  Phase B runs under the profiler
    ranges ``population/draw``, ``population/train`` and
    ``population/aggregate``.  ``info`` holds ``selected``,
    ``live``, ``scores``, ``num_selected``, ``hist_sum``, ``n_valid`` and
    ``union_coverage``."""
    if num_clients % block_size:
        raise ValueError(f"block_size ({block_size}) must divide num_clients "
                         f"({num_clients})")
    wl = get_workload(workload)
    dev = resolve_device(device) if ds is None else torch.device(ds.device)
    ds = wl.make_dataset(dev) if ds is None else ds
    n_classes = wl.num_classes(ds)
    _check_block_separable(strategy, "population", n_classes, dev)
    e_blocks = num_clients // block_size
    budget = max(1, min(int(budget), num_clients))
    opt = get_optimizer(optimizer, lr)
    loss_fn = wl.make_loss(ds)

    def labels_for_blocks(kp):
        def labels(blocks, ids):
            return plan_fn(kp, ids.reshape(-1)).reshape(ids.shape + (-1,))
        return labels

    def round_fn(params: Params, key_t) -> Tuple[Params, Dict[str, Any]]:
        key_t = rng.as_key(key_t, dev)
        kp = rng.fold_in(key_t, 0)      # plan stream
        kd = rng.fold_in(key_t, 1)      # payload stream
        ks = rng.fold_in(key_t, 2)      # strategy stream
        ids, live_b, scores, stats = streamed_selection(
            labels_for_blocks(kp), None, num_blocks=e_blocks,
            block_size=block_size, num_classes=n_classes, strategy=strategy,
            key=ks, budget=budget, chunk_blocks=chunk_blocks)
        live = live_b.to(torch.float32)
        idx = ids.long()
        with record_function("population/draw"):
            data = materialize_rows(wl, ds, plan_fn(kp, ids), kd, idx)
            batches = client_batches(data, batch_size, wl.batch_keys)
            sizes = data["valid"].reshape(budget, -1).sum(-1).to(
                torch.float32)
            del data
        with record_function("population/train"):
            trained, _ = local_train(start_models(_stack_trial(params),
                                                  budget),
                                     opt, batches, loss_fn, local_epochs)
            del batches
        with record_function("population/aggregate"):
            owner = idx // block_size
            ranks = torch.searchsorted(torch.unique(owner), owner)
            agg_p = two_tier_weighted_mean(trained, live, sizes, ranks,
                                           budget)
            new = interpolate(params, agg_p, server_lr)
            any_live = live.sum() > 0
            new = {k: torch.where(any_live, v, params[k])
                   for k, v in new.items()}
        info = {"selected": ids, "live": live, "scores": scores,
                "num_selected": live.sum(), "hist_sum": stats["hist_sum"],
                "n_valid": stats["n_valid"],
                "union_coverage": stats["present"].sum().to(torch.int32)}
        return new, info

    round_fn.num_blocks = e_blocks
    round_fn.block_size = block_size
    round_fn.budget = budget
    return round_fn
