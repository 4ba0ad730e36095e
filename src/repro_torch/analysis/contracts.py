"""Contract verification for the registry axes, over aten graphs.

Every registered strategy / workload / aggregator / metric must run inside
the engines' round bodies, which means its contract — documented prose in
``repro_torch.core.selection`` / ``repro_torch.fl.workloads`` /
``repro_torch.core.aggregation`` / ``repro_torch.obs.registry`` — is
checkable *abstractly*, before a round runs: the callable runs over fake
tensors (shapes, dtypes and a device, no storage), so schema violations,
data-dependent control flow, host round trips, constant-seeded keys and
block-separability all surface here as structured
:class:`~repro_torch.analysis.diagnostics.Diagnostic` findings instead of a
stack trace from inside an engine.  This is the port of the reference's
``repro/analysis/contracts.py``; where the reference runs
``jax.eval_shape`` the port runs the callable under a ``FakeTensorMode``,
and where it reads ``jax.make_jaxpr`` the port reads the functionalised
aten graph of ``make_fx(..., tracing_mode="fake")``
(:func:`~repro_torch.analysis.separability.trace_graph`).  The kernels'
launches are ``repro_torch`` custom ops with fake forms, so the passes
trace through them on the card as on the CPU.

How the reference's trace-time codes map onto the fake tracer:

* **A001** (A102 / A202 / A301 for the other axes) — the body branches on
  a traced value or reads it as a Python number:
  ``GuardOnDataDependentSymNode``, ``DataDependentOutputException``,
  ``DynamicOutputShapeException``, or an input-dependent
  ``aten._local_scalar_dense`` in the graph (:data:`TRACE_ERRORS`); the
  counterpart of JAX's concretization errors.
* **A002** — any other error raised under the fake tracer.
* **A005** — a host round trip inside the traced body: ``.numpy()``,
  ``.tolist()`` or ``np.asarray(t)`` (seen by a ``TorchFunctionMode``
  during the trace, which answers zeros of the right shape so the trace
  goes on), or a node that copies a tensor from the card to the host: the
  port's counterpart of a callback primitive.
* **A006** — the ``repro_torch::random_seed`` op of ``rng.PRNGKey`` in the
  graph: a key built from a seed inside the body, where it should come
  from the engine's folded key argument.

Three entry points:

* ``check_strategy`` / ``check_workload`` / ``check_aggregator`` /
  ``check_metric`` — one registry entry each, returning :class:`Findings`;
* ``check_spec(spec)`` — exactly the entries an ``ExperimentSpec``
  resolves, at the spec's own shapes (``ExperimentSpec.validate(deep=True)``
  raises :class:`ContractError` when this finds errors);
* ``check_registries()`` — every registered entry at canonical shapes (the
  ``python -m repro_torch.analysis`` contract layer).

Every entry point takes ``device`` (``None``: the card); the fake tensors
and the classifier's probe lie there.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensorMode)
from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode
from torch.utils import _pytree as pytree

from ..device import resolve_device
from .diagnostics import ContractError, Findings
from .separability import (HostConversionError, classify_strategy,
                           graph_ops, trace_graph, verdict_from_graph)

# Data-dependent control flow or host conversion of a traced value: the
# error family the fake tracer raises where JAX raises a concretization
# error.
TRACE_ERRORS = (GuardOnDataDependentSymNode, DataDependentOutputException,
                DynamicOutputShapeException, HostConversionError)

# ``rng.PRNGKey``'s op inside a traced body means a key was built from a
# seed — the same draw every round, never what a strategy or materializer
# wants (engines hand every callable an already-folded key).
CONST_SEEDED_PRNG = frozenset({"repro_torch.random_seed.default"})


def _scan_forbidden(gm, trips: Dict[str, int], kind: str, name: str,
                    where: str, out: Findings) -> None:
    ops = graph_ops(gm)
    for op in sorted(CONST_SEEDED_PRNG & set(ops)):
        out.add("A006", "error", kind, name,
                f"constant-seeded PRNG in traced {where} "
                f"({op} ×{ops[op]}): keys must come from the engine's "
                "folded key argument, never rng.PRNGKey(const)",
                primitive=op, count=ops[op], where=where)
    for trip, count in sorted(trips.items()):
        out.add("A005", "error", kind, name,
                f"host round trip {trip!r} ×{count} in traced {where}: a "
                "value taken to the host cannot ride in the engines' round "
                "bodies", primitive=trip, count=count, where=where)


def _trace_diag(out: Findings, e: Exception, *, kind: str, name: str,
                where: str) -> None:
    """Fold a trace-time exception into one structured diagnostic."""
    first_line = str(e).strip().split("\n")[0]
    if isinstance(e, TRACE_ERRORS):
        out.add("A001" if kind == "strategy" else "A102", "error", kind, name,
                f"{where} concretizes a traced value host-side "
                f"({type(e).__name__}): {first_line}",
                where=where, error=type(e).__name__)
    else:
        out.add("A002" if kind == "strategy" else "A102", "error", kind, name,
                f"{where} raised under abstract evaluation "
                f"({type(e).__name__}): {first_line}",
                where=where, error=type(e).__name__)


def _fake(mode: FakeTensorMode, shape, dtype, device) -> torch.Tensor:
    with mode:
        return torch.empty(tuple(shape), dtype=dtype, device=device)


def _traced(fn: Callable, *args):
    """``trace_graph`` of ``fn(*args)``, keeping ``fn``'s own output (a
    pytree of fake tensors and anything else) beside the graph."""
    cell: list = []

    def body(*a):
        res = fn(*a)
        cell.append(res)
        return [x for x in pytree.tree_leaves(res)
                if isinstance(x, torch.Tensor)]

    gm, trips = trace_graph(body, *args)
    return cell[0], gm, trips


def _fake_run(mode: FakeTensorMode, fn: Callable, *args):
    """``fn(*args)`` under ``mode``: shapes and dtypes only (the
    reference's ``jax.eval_shape``)."""
    with mode:
        return fn(*args)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Strategy contract
# ---------------------------------------------------------------------------

def check_strategy(name: str, fn: Callable, *, num_clients: int = 16,
                   num_classes: int = 10, n_select: int = 8,
                   separability: bool = True,
                   device: "str | torch.device | None" = None) -> Findings:
    """Verify one selection strategy against the ``register_strategy``
    contract: traceable, SelectionResult schema (mask/scores/order shapes and
    dtypes, static-int budget), no host round trip or seeded key, plus the
    block-separability classification (reported as info — engines that need
    the property enforce it; ``sim``/``host``/``sharded`` don't)."""
    dev = resolve_device(device)
    out = Findings()
    where = f"fn(key, hists[{num_clients},{num_classes}], {n_select})"
    def fields(key, hists):      # outputs mask, scores, order (if tensors)
        r = fn(key, hists, n_select)
        return [getattr(r, f, None) for f in ("mask", "scores", "order")], r

    try:
        (_, r), gm, trips = _traced(
            fields, torch.zeros(2, dtype=torch.int64, device=dev),
            torch.zeros(num_clients, num_classes, device=dev))
    except Exception as e:
        _trace_diag(out, e, kind="strategy", name=name, where=where)
        return out

    want = {"mask": ((num_clients,), torch.float32),
            "scores": ((num_clients,), torch.float32),
            "order": ((num_clients,), torch.int32)}
    got_fields = {f: getattr(r, f, None) for f in want}
    if not all(isinstance(x, torch.Tensor) for x in got_fields.values()):
        leaves = sum(isinstance(x, torch.Tensor)
                     for x in pytree.tree_leaves(r))
        out.add("A003", "error", "strategy", name,
                f"fn must return SelectionResult(mask, scores, order, budget);"
                f" traced output has {leaves} array leaves", leaves=leaves)
        return out
    for field, (shape, dtype) in want.items():
        got = got_fields[field]
        if tuple(got.shape) != shape or got.dtype != dtype:
            out.add("A003", "error", "strategy", name,
                    f"SelectionResult.{field} must be {_dtype_name(dtype)}"
                    f"{list(shape)}; got {_dtype_name(got.dtype)}"
                    f"{list(got.shape)}",
                    field=field, want_shape=list(shape),
                    want_dtype=_dtype_name(dtype),
                    got_shape=list(got.shape),
                    got_dtype=_dtype_name(got.dtype))
    budget = getattr(r, "budget", "MISSING")
    if budget is not None and (isinstance(budget, bool)
                               or not isinstance(budget, int)):
        out.add("A004", "error", "strategy", name,
                "SelectionResult.budget must be a static Python int or None "
                "(the engines' gather width is a trace-time shape); got "
                f"{type(budget).__name__}",
                budget_type=type(budget).__name__)
    _scan_forbidden(gm, trips, "strategy", name, "strategy body", out)

    if separability:
        n_cls = max(8, min(num_clients, 64))
        if n_cls == num_clients:       # the scores of this pass's own trace
            v = verdict_from_graph(fn, gm, trips, 1, name=name,
                                   num_clients=n_cls,
                                   num_classes=num_classes, probe=True,
                                   device=dev)
        else:
            v = classify_strategy(fn, num_clients=n_cls,
                                  num_classes=num_classes, name=name,
                                  device=dev)
        out.add("A007", "info", "strategy", name,
                "block-separability: "
                f"{'separable' if v.separable else 'NOT separable'}"
                f" (scores={v.scores_dep}, mask_probe={v.mask_consistent})",
                separable=v.separable, scores_dep=v.scores_dep,
                mask_consistent=v.mask_consistent,
                reasons=list(v.reasons))
    return out


# ---------------------------------------------------------------------------
# Workload contract
# ---------------------------------------------------------------------------

# (name, id(wl), num_clients, plan_n, device) -> (wl, findings) of a
# workload checked over its own default dataset: a registered Workload is a
# frozen bundle, so that check gives the same findings every time (the
# workload is kept beside them, so a new bundle under a reused id misses).
_DEFAULT_DS_CHECKS: Dict[tuple, tuple] = {}


def check_workload(name: str, wl, *, ds: Any = None, num_clients: int = 8,
                   plan_n: int = 6,
                   device: "str | torch.device | None" = None) -> Findings:
    """Verify one workload bundle: ``materialize`` schema (``labels`` /
    ``valid`` / ``hists`` + declared ``batch_keys``, histogram width =
    ``num_classes``), traceable init/loss, and eval metrics containing
    ``"accuracy"``.  ``ds`` defaults to ``wl.make_dataset(device)`` (whose
    findings are kept for the next call on the same bundle); the dataset's
    own tensors stay real and join the traces as constants."""
    dev = resolve_device(device)
    if ds is None:
        key = (name, id(wl), num_clients, plan_n, str(dev))
        hit = _DEFAULT_DS_CHECKS.get(key)
        if hit is None or hit[0] is not wl:
            hit = _DEFAULT_DS_CHECKS[key] = (wl, list(_check_workload(
                name, wl, None, num_clients, plan_n, dev)))
        return Findings(hit[1])
    return _check_workload(name, wl, ds, num_clients, plan_n, dev)


def _check_workload(name: str, wl, ds: Any, num_clients: int, plan_n: int,
                    dev: torch.device) -> Findings:
    out = Findings()
    try:
        ds = wl.make_dataset(dev) if ds is None else ds
        num_classes = int(wl.num_classes(ds))
    except Exception as e:
        _trace_diag(out, e, kind="workload", name=name,
                    where="make_dataset/num_classes")
        return out

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    plan = _fake(mode, (num_clients, plan_n), torch.int32, dev)
    key = _fake(mode, (2,), torch.int64, dev)

    # -- materialize: schema and the graph's forbidden ops -----------------
    mat = None
    where = f"materialize(ds, plan[{num_clients},{plan_n}], key)"
    try:
        mat, gm, trips = _traced(lambda p, k: wl.materialize(ds, p, k),
                                 plan, key)
        _scan_forbidden(gm, trips, "workload", name, "materialize", out)
    except Exception as e:
        _trace_diag(out, e, kind="workload", name=name, where=where)
    if mat is not None and not isinstance(mat, dict):
        out.add("A101", "error", "workload", name,
                f"materialize must return a dict; got {type(mat).__name__}")
        mat = None
    if mat is not None:
        want = {"labels": ((num_clients, plan_n), torch.int32),
                "valid": ((num_clients, plan_n), torch.bool),
                "hists": ((num_clients, num_classes), torch.float32)}
        for k, (shape, dtype) in want.items():
            if k not in mat:
                out.add("A101", "error", "workload", name,
                        f"materialize output is missing required key {k!r} "
                        f"(contract: labels/valid/hists + batch_keys)",
                        missing_key=k, have=sorted(mat))
                continue
            got = mat[k]
            if tuple(got.shape) != shape or got.dtype != dtype:
                out.add("A101", "error", "workload", name,
                        f"materialize[{k!r}] must be {_dtype_name(dtype)}"
                        f"{list(shape)}; got {_dtype_name(got.dtype)}"
                        f"{list(got.shape)}",
                        key=k, want_shape=list(shape),
                        got_shape=list(got.shape),
                        got_dtype=_dtype_name(got.dtype))
        for k in wl.batch_keys:
            if k not in mat:
                out.add("A101", "error", "workload", name,
                        f"declared batch_keys entry {k!r} is absent from the "
                        "materialize output", missing_key=k)
            elif tuple(mat[k].shape[:2]) != (num_clients, plan_n):
                out.add("A101", "error", "workload", name,
                        f"batch_keys leaf {k!r} must lead with "
                        f"(N, n_max) = ({num_clients}, {plan_n}); got "
                        f"{list(mat[k].shape)}",
                        key=k, got_shape=list(mat[k].shape))

    # -- init / loss / eval -------------------------------------------------
    params = None
    try:
        params = _fake_run(mode, wl.init, key, ds)
    except Exception as e:
        _trace_diag(out, e, kind="workload", name=name, where="init(key, ds)")
    if params is not None and mat is not None and not out.errors():
        batch = {k: _fake(mode, mat[k].shape[1:], mat[k].dtype, dev)
                 for k in wl.batch_keys}
        try:
            loss_out = _fake_run(mode, wl.make_loss(ds), params, batch)
            if tuple(loss_out[0].shape) != ():
                out.add("A102", "error", "workload", name,
                        "make_loss(ds)(params, batch) must return a scalar "
                        f"loss first; got shape {list(loss_out[0].shape)}")
        except Exception as e:
            _trace_diag(out, e, kind="workload", name=name,
                        where="make_loss(ds)(params, one-client batch)")
    if params is not None:
        try:
            eval_batch = wl.eval_set(ds, 2)
            _, metrics = _fake_run(mode, wl.make_eval(ds), params,
                                   eval_batch)
            if not isinstance(metrics, dict) or "accuracy" not in metrics:
                have = sorted(metrics) if isinstance(metrics, dict) else \
                    type(metrics).__name__
                out.add("A103", "error", "workload", name,
                        'make_eval metrics must contain "accuracy" (the '
                        f"trajectory every engine records); got {have}",
                        have=have)
        except Exception as e:
            _trace_diag(out, e, kind="workload", name=name,
                        where="make_eval(ds)(params, eval_set(ds, 2))")
    return out


def param_shapes(wl, ds: Any) -> Dict[str, torch.Tensor]:
    """The workload's params as meta tensors (shapes and dtypes, no
    storage): ``wl.init`` run over fake tensors."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    key = _fake(mode, (2,), torch.int64, ds.device)
    params = _fake_run(mode, wl.init, key, ds)
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Aggregator contract
# ---------------------------------------------------------------------------

def check_aggregator(name: str, agg, *, params: Any = None,
                     num_slots: int = 5,
                     device: "str | torch.device | None" = None) -> Findings:
    """Verify one aggregation family.  Builtin reductions (``reduce=None``)
    resolve to the parity-pinned dispatch and need no trace; a custom
    ``reduce`` must map ``(stacked, live, sizes) -> tree`` preserving the
    per-client tree structure, shapes and dtypes.  ``params`` is a tree of
    tensors whose shapes and dtypes (not values) are used."""
    dev = resolve_device(device)
    out = Findings()
    if agg.reduce is None:
        return out
    if params is None:
        params = {"w": torch.empty((4, 3), device="meta"),
                  "b": torch.empty((3,), device="meta")}
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    stacked = pytree.tree_map(
        lambda p: _fake(mode, (num_slots,) + tuple(p.shape), p.dtype, dev),
        params)
    live = _fake(mode, (num_slots,), torch.float32, dev)
    sizes = _fake(mode, (num_slots,), torch.float32, dev)
    try:
        got, gm, trips = _traced(agg.reduce, stacked, live, sizes)
    except Exception as e:
        first_line = str(e).strip().split("\n")[0]
        what = ("concretizes a traced value host-side"
                if isinstance(e, TRACE_ERRORS)
                else "raised under abstract evaluation")
        out.add("A202", "error", "aggregator", name,
                f"custom reduce {what} — reduce(stacked, live, sizes) "
                f"({type(e).__name__}): {first_line}",
                error=type(e).__name__)
        return out
    want_td = pytree.tree_structure(params)
    got_td = pytree.tree_structure(got)
    if want_td != got_td:
        out.add("A201", "error", "aggregator", name,
                "custom reduce must return the per-client tree structure "
                f"{want_td}; got {got_td}")
        return out
    for (path, w), g in zip(pytree.tree_leaves_with_path(params),
                            pytree.tree_leaves(got)):
        if not isinstance(g, torch.Tensor) or tuple(w.shape) != tuple(
                g.shape) or w.dtype != g.dtype:
            leaf = pytree.keystr(path)
            gshape = list(getattr(g, "shape", ()))
            out.add("A201", "error", "aggregator", name,
                    f"custom reduce leaf {leaf} must be "
                    f"{_dtype_name(w.dtype)}{list(w.shape)}; got "
                    f"{_dtype_name(getattr(g, 'dtype', type(g)))}{gshape}",
                    leaf=leaf, want_shape=list(w.shape), got_shape=gshape)
    _scan_forbidden(gm, trips, "aggregator", name, "reduce", out)
    return out


# ---------------------------------------------------------------------------
# Metric contract (repro_torch.obs registry)
# ---------------------------------------------------------------------------

# Metric series ride every engine's per-round record (one slot per round per
# grid cell); anything bigger than this is a trajectory, not a metric.
MAX_METRIC_ELEMS = 4096


def _metric_state(mode: FakeTensorMode, device, num_clients: int,
                  num_classes: int, n_clusters: int, buffer_k: int):
    """The canonical abstract round-state: the superset of every engine's
    documented keys (repro_torch.obs.registry) at small shapes, as fake
    tensors."""
    def f(shape, dtype=torch.float32):
        return _fake(mode, shape, dtype, device)

    def params():
        return {"w": f((3, 2)), "b": f((2,))}

    return {
        "hists": f((num_clients, num_classes)),
        "mask": f((num_clients,)),
        "params_old": params(), "params_new": params(),
        "assign": f((num_clients,), torch.int32),
        "centroids": f((n_clusters, num_classes)),
        "prev_centroids": f((n_clusters, num_classes)),
        "staleness_delays": f((buffer_k,), torch.int32),
        "client_update_norms": f((num_clients,)),
    }


def check_metric(name: str, metric: Any = None, *, num_clients: int = 16,
                 num_classes: int = 10, n_clusters: int = 4,
                 buffer_k: int = 4, tau_max: int = 2,
                 device: "str | torch.device | None" = None) -> Findings:
    """Verify one round metric (repro_torch.obs registry) against its
    contract: ``fn(round_state)`` traceable over the canonical abstract
    state (A301), returning exactly one small tensor whose rank matches the
    declared trailing ``axes`` (A302), with no host round trip or seeded key
    in the traced body (the shared A005/A006 scan) — metrics run inside
    every engine's round, so a round trip here would sync the host every
    round."""
    from ..obs import get_metric
    dev = resolve_device(device)
    out = Findings()
    if metric is None:
        metric = get_metric(name)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    dyn = _metric_state(mode, dev, num_clients, num_classes, n_clusters,
                        buffer_k)
    statics = {"num_classes": num_classes, "n_clusters": n_clusters,
               "tau_max": tau_max}
    try:
        res, gm, trips = _traced(lambda d: metric.fn({**statics, **d}), dyn)
    except Exception as e:
        first_line = str(e).strip().split("\n")[0]
        verb = ("concretizes a traced value host-side"
                if isinstance(e, TRACE_ERRORS)
                else "raised under abstract evaluation")
        out.add("A301", "error", "metric", name,
                f"metric fn {verb} over the canonical round state "
                f"({type(e).__name__}): {first_line}",
                error=type(e).__name__)
        return out

    leaves = [x for x in pytree.tree_leaves(res)]
    if len(leaves) != 1 or not isinstance(leaves[0], torch.Tensor):
        out.add("A302", "error", "metric", name,
                "metric fn must return one tensor (scalar or small vector); "
                f"traced output has {len(leaves)} leaves",
                leaves=len(leaves))
    else:
        shape = tuple(int(d) for d in leaves[0].shape)
        size = 1
        for d in shape:
            size *= d
        if size > MAX_METRIC_ELEMS:
            out.add("A302", "error", "metric", name,
                    f"metric output {list(shape)} has {size} elements "
                    f"(> {MAX_METRIC_ELEMS}); series ride every engine's "
                    "round record per grid cell and must stay small",
                    shape=list(shape), size=size)
        if len(shape) != len(metric.axes):
            out.add("A302", "error", "metric", name,
                    f"metric output rank {len(shape)} does not match the "
                    f"declared trailing axes {list(metric.axes)}",
                    shape=list(shape), axes=list(metric.axes))
    _scan_forbidden(gm, trips, "metric", name, "metric body", out)
    return out


# ---------------------------------------------------------------------------
# Spec-level and registry-wide entry points
# ---------------------------------------------------------------------------

def check_spec(spec, *, ds: Any = None,
               device: "str | torch.device | None" = None) -> Findings:
    """Run the contract passes on exactly the registry entries ``spec``
    resolves, at the spec's own shapes — the ``validate(deep=True)``
    backend."""
    from ..core.aggregation import get_aggregator
    from ..core.selection import STRATEGIES
    from ..fl.workloads import get_workload

    dev = resolve_device(device)
    out = Findings()
    wl = get_workload(spec.workload)
    out.extend(check_workload(wl.name, wl, ds=ds, device=dev,
                              num_clients=min(int(spec.fl.num_clients), 8)))
    try:
        resolved_ds = wl.make_dataset(dev) if ds is None else ds
        num_classes = int(wl.num_classes(resolved_ds))
    except Exception:
        resolved_ds, num_classes = None, 10   # diagnosed by check_workload
    for s in spec.strategies:
        out.extend(check_strategy(
            s, STRATEGIES[s], device=dev,
            num_clients=max(2, min(int(spec.fl.num_clients), 64)),
            num_classes=num_classes,
            n_select=max(1, min(int(spec.fl.clients_per_round),
                                int(spec.fl.num_clients)))))
    agg_name = spec.aggregation or spec.fl.aggregation
    agg = get_aggregator(agg_name)
    if agg.reduce is not None:
        try:
            params = param_shapes(wl, resolved_ds)
        except Exception:
            params = None
        out.extend(check_aggregator(agg_name, agg, params=params,
                                    device=dev))
    # Requested round metrics trace at the spec's own client count; "auto"
    # expands to every registered metric (the engines would resolve it the
    # same way).
    tel = tuple(getattr(spec, "telemetry", ()))
    if tel:
        from ..obs import registered_metrics
        names = registered_metrics() if "auto" in tel else \
            tuple(dict.fromkeys(n for n in tel if n != "auto"))
        for mname in names:
            out.extend(check_metric(
                mname, num_clients=max(2, min(int(spec.fl.num_clients), 64)),
                num_classes=num_classes, device=dev))
    return out


def check_registries(device: "str | torch.device | None" = None
                     ) -> Findings:
    """Contract passes over EVERY registered strategy, workload, aggregator
    and metric at canonical shapes — the ``python -m repro_torch.analysis``
    contract layer.  Importing the experiment module first is what
    populates the registries with their import-time extensions."""
    from ..fl import experiment  # noqa: F401  (registers extensions)
    from ..core.aggregation import AGGREGATORS
    from ..core.selection import STRATEGIES
    from ..fl.workloads import _WORKLOADS
    from ..obs import get_metric, registered_metrics

    dev = resolve_device(device)
    out = Findings()
    for name, fn in list(STRATEGIES.items()):
        out.extend(check_strategy(name, fn, device=dev))
    for name, wl in list(_WORKLOADS.items()):
        out.extend(check_workload(name, wl, device=dev))
    for name, agg in list(AGGREGATORS.items()):
        out.extend(check_aggregator(name, agg, device=dev))
    for name in registered_metrics():
        out.extend(check_metric(name, get_metric(name), device=dev))
    return out


def assert_strategy_contract(name: str, fn: Callable, **kw: Any) -> None:
    """Raise :class:`ContractError` if ``fn`` violates the strategy
    contract — the ``register_strategy(..., check=True)`` hook."""
    findings = check_strategy(name, fn, **kw)
    if findings.errors():
        raise ContractError(findings)


def assert_workload_contract(name: str, wl, **kw: Any) -> None:
    """Raise :class:`ContractError` on a bad workload bundle — the
    ``register_workload(..., check=True)`` hook."""
    findings = check_workload(name, wl, **kw)
    if findings.errors():
        raise ContractError(findings)


def assert_aggregator_contract(name: str, agg, **kw: Any) -> None:
    """Raise :class:`ContractError` on a bad aggregation family — the
    ``register_aggregator(..., check=True)`` hook."""
    findings = check_aggregator(name, agg, **kw)
    if findings.errors():
        raise ContractError(findings)


def assert_metric_contract(name: str, metric: Any = None,
                           **kw: Any) -> None:
    """Raise :class:`ContractError` on a bad round metric — the
    ``register_metric(..., check=True)`` hook (repro_torch.obs)."""
    findings = check_metric(name, metric, **kw)
    if findings.errors():
        raise ContractError(findings)
