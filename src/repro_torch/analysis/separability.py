"""Block-separability of selection strategies, proven from the aten graph.

The hier/async/population engines stream clients through blocks and call the
registered strategy once per block (repro_torch.fl.population).  That is only
correct when client i's SCORE is a row-wise function of its own histogram
row — a strategy whose score reads other rows (``labelwise_priority``'s
population-wide label-union count) silently mis-ranks across blocks.  This
module is the port of the reference's classifier
(``repro/analysis/separability.py``), over the graph ``make_fx`` traces
where the reference reads a jaxpr:

* **Graph dependence pass** — trace ``fn(key, hists, N)`` over fake tensors
  (``make_fx(functionalize(fn), tracing_mode="fake")``: in-place writes
  such as ``histogram``'s ``out[..., c] = …`` become ``select_scatter`` /
  ``slice_scatter`` nodes and views become ``*_copy`` nodes, so every node
  is a value) and propagate a three-point lattice over every node:

      CONST        — no dependence on ``hists`` at all
      ROW(axis)    — element ``i`` along ``axis`` depends only on hists
                     row ``i`` (plus CONST data)
      GLOBAL       — mixes histogram rows

  Ops tagged ``torch.Tag.pointwise`` join their operands' tags under
  trailing-dim broadcasting; reductions, cumulative ops, ``sort`` and
  ``topk`` along the client axis promote to GLOBAL, along any other axis
  keep ROW with the axis renumbered; ``view``/``reshape``, ``permute``/
  ``transpose``, ``unsqueeze``/``squeeze``, ``expand``, ``slice``/
  ``select`` and their scatters map the axis (negative ``dim`` arguments
  normalised first).  Any other op degrades conservatively (CONST inputs
  stay CONST, anything else goes GLOBAL, with the op recorded as evidence):
  ``gather`` unless proven aligned, ``index``, ``scatter`` and the kernels'
  ``repro_torch`` ops among them.  The verdict reads the tag of the
  ``scores`` output only — the mask/order path legitimately runs a global
  argsort.

* **Saturated-mask probe** — the mask cannot be proven row-wise statically
  (it routes through that global argsort), but the streamed engines only
  ever call strategies with ``n_select = block_size``, where the returned
  mask degenerates to the strategy's validity gate.  The probe checks the
  degenerate identity concretely on a small deterministic histogram matrix,
  on the caller's device: ``fn(key, H, N).mask`` must equal the
  concatenation of the per-block masks under ``rng.fold_in(key, b)``.

The combined verdict (scores ROW/CONST *and* probe-consistent) is what
``repro_torch.fl.population`` enforces for every strategy that is not
explicitly denylisted or allowlisted.

The tracing helpers here (:func:`trace_graph`, :class:`HostRoundTrips`) are
shared with ``repro_torch.analysis.contracts``.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.overrides import TorchFunctionMode

from .. import rng
from ..device import resolve_device

# Dependence lattice: ("const", -1) ⊑ ("row", axis) ⊑ ("global", -1).
Dep = Tuple[str, int]
CONST: Dep = ("const", -1)
GLOBAL: Dep = ("global", -1)


def _row(axis: int) -> Dep:
    return ("row", int(axis))


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

# Tensor methods that take a value to the host: the port's counterpart of a
# callback.  Under the fake tracer they would read storage that does not
# exist, so they answer zeros of the right shape and the trace goes on.
_HOST_READS = {"numpy": lambda t: np.zeros(tuple(t.shape), _np_dtype(t)),
               "__array__": lambda t: np.zeros(tuple(t.shape), _np_dtype(t)),
               "tolist": lambda t: np.zeros(tuple(t.shape),
                                            _np_dtype(t)).tolist()}


def _np_dtype(t: torch.Tensor):
    return torch.empty((), dtype=t.dtype).numpy().dtype \
        if t.dtype != torch.bfloat16 else np.float32


class HostRoundTrips(TorchFunctionMode):
    """Records the host reads a functionalised body makes (``.numpy()``,
    ``.tolist()``, ``np.asarray(t)``) and answers each with zeros of the
    right shape, so that the trace continues past it."""

    def __init__(self):
        super().__init__()
        self.seen: Dict[str, int] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _HOST_READS and args and isinstance(args[0], torch.Tensor):
            key = f"Tensor.{name}"
            self.seen[key] = self.seen.get(key, 0) + 1
            return _HOST_READS[name](args[0])
        return func(*args, **(kwargs or {}))


def _host_copies(gm: torch.fx.GraphModule) -> int:
    """The nodes of ``gm`` that copy a tensor from an accelerator to the
    host (a copy within the CPU is no round trip)."""
    def devices(x):
        v = _val(x)
        return {v.device.type} if isinstance(v, torch.Tensor) else set()

    count = 0
    for node in gm.graph.nodes:
        if node.op == "call_function" and devices(node) == {"cpu"} and any(
                devices(a) - {"cpu"} for a in node.all_input_nodes):
            count += 1
    return count


class HostConversionError(RuntimeError):
    """A traced body read a traced value as a Python number
    (``.item()``, ``float(t)``): the graph holds
    ``aten._local_scalar_dense`` on a value that depends on the inputs."""


def _input_dependent(gm: torch.fx.GraphModule) -> set:
    """The nodes of ``gm`` that depend on a placeholder."""
    dep = set()
    for node in gm.graph.nodes:
        if node.op == "placeholder" or any(
                a in dep for a in node.all_input_nodes):
            dep.add(node)
    return dep


def trace_graph(fn: Callable, *args: Any
                ) -> Tuple[torch.fx.GraphModule, Dict[str, int]]:
    """The aten graph of ``torch.func.functionalize(fn)(*args)`` over fake
    tensors, and the host round trips the body made (host reads and copies
    to the host, by kind).  ``args`` are pytrees of example tensors (real,
    or fake tensors of one ``FakeTensorMode``, whose mode the trace then
    shares); tensors ``fn`` closes over join the graph as constants.
    Functionalised, in-place writes become ``*_scatter`` nodes and views
    ``*_copy`` nodes, so that every node is a value, and host reads are
    seen.  (An ``autograd.Function`` with a ``vmap`` rule, as the attention
    and SSD kernels' are, cannot be functionalised; no registry callable
    but a workload's loss and eval calls one, and those the passes run
    without a graph.)  Raises what the body raises under the fake tracer,
    and :class:`HostConversionError` where it reads an input-dependent
    value as a Python number."""
    watch = HostRoundTrips()

    def body(*a):
        with watch:
            return fn(*a)

    gm = make_fx(torch.func.functionalize(body, remove="mutations_and_views"),
                 tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
    dep = _input_dependent(gm)
    for node in gm.graph.nodes:
        if node.target is torch.ops.aten._local_scalar_dense.default \
                and node in dep:
            raise HostConversionError(
                "a traced value is read as a Python number (.item(), "
                "float(t), int(t))")
    trips = dict(watch.seen)
    copies = _host_copies(gm)
    if copies:
        trips["copy to host"] = copies
    return gm, trips


def graph_ops(gm: torch.fx.GraphModule) -> Dict[str, int]:
    """Op name (``aten.sum.dim_IntList``, ``repro_torch.label_hist.default``
    …) -> count, over the call nodes of ``gm``."""
    seen: Dict[str, int] = {}
    for node in gm.graph.nodes:
        if node.op == "call_function" and isinstance(
                node.target, torch._ops.OpOverload):
            name = str(node.target)
            seen[name] = seen.get(name, 0) + 1
    return seen


# ---------------------------------------------------------------------------
# The dependence pass
# ---------------------------------------------------------------------------

_IDENTITY = frozenset({"alias", "clone", "detach", "lift_fresh", "_to_copy",
                       "contiguous", "lift", "resolve_conj", "resolve_neg",
                       "_conj", "to"})
# Values that do not depend on any input's values (``*_like`` reads only a
# shape).
_SOURCES = frozenset({"arange", "zeros", "ones", "full", "empty",
                      "empty_strided", "scalar_tensor", "linspace", "eye",
                      "zeros_like", "ones_like", "full_like", "empty_like",
                      "new_zeros", "new_ones", "new_full", "new_empty",
                      "randn_like", "rand_like"})
_REDUCE = frozenset({"sum", "mean", "prod", "amax", "amin", "max", "min",
                     "argmax", "argmin", "any", "all", "var", "std",
                     "var_mean", "std_mean", "logsumexp", "nansum",
                     "linalg_vector_norm", "norm", "count_nonzero", "median",
                     "nanmedian", "mode", "aminmax"})
_CUMULATIVE = frozenset({"cumsum", "cumprod", "cummax", "cummin",
                         "logcumsumexp"})
_SORT = frozenset({"sort", "argsort", "topk", "kthvalue", "msort"})
_VIEW = frozenset({"view", "_unsafe_view", "reshape", "_reshape_alias"})


def _op_name(target) -> str:
    """The op's overload-packet name with a functionalised view's ``_copy``
    suffix dropped (``select_copy`` -> ``select``)."""
    name = target.overloadpacket.__name__
    if torch.Tag.view_copy in target.tags and name.endswith("_copy"):
        name = name[:-len("_copy")]
    return name


def _bound(node) -> Dict[str, Any]:
    """The node's arguments by schema name, defaults filled in."""
    out = {}
    for i, a in enumerate(node.target._schema.arguments):
        if i < len(node.args):
            out[a.name] = node.args[i]
        elif a.name in node.kwargs:
            out[a.name] = node.kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
    return out


def _val(x):
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else None


def _shape(x) -> Tuple[int, ...]:
    v = _val(x)
    if isinstance(v, (tuple, list)):
        v = next((t for t in v if isinstance(t, torch.Tensor)), None)
    return tuple(int(d) for d in v.shape) if isinstance(v, torch.Tensor) \
        else ()


def _norm(dim: int, rank: int) -> int:
    return dim + rank if dim < 0 else dim


def _aligned_row_axis(dep: Dep, op_shape: Tuple[int, ...],
                      out_shape: Tuple[int, ...]) -> Dep:
    """Map an operand's row axis into the output axis space under trailing-
    dim broadcast alignment."""
    if dep[0] != "row":
        return dep
    shift = len(out_shape) - len(op_shape)
    if shift < 0:
        return GLOBAL
    return _row(dep[1] + shift)


def _join_elementwise(deps_shapes: Sequence[Tuple[Dep, Tuple[int, ...]]],
                      out_shape: Tuple[int, ...]) -> Dep:
    axes = set()
    for dep, shape in deps_shapes:
        dep = _aligned_row_axis(dep, shape, out_shape)
        if dep[0] == "global":
            return GLOBAL
        if dep[0] == "row":
            axes.add(dep[1])
    if not axes:
        return CONST
    if len(axes) > 1:
        return GLOBAL          # two different row alignments mixed
    return _row(axes.pop())


def _map_axis_through_reshape(old: Tuple[int, ...], new: Tuple[int, ...],
                              axis: int) -> Optional[int]:
    """The output axis a reshape maps ``old[axis]`` to, if the factorization
    keeps that axis intact (same extent, same leading-element stride block);
    ``None`` when the reshape folds it."""
    lead = math.prod(old[:axis])
    acc = 1
    for j, extent in enumerate(new):
        if acc == lead and extent == old[axis]:
            return j
        acc *= extent
    return None


def _tensor_args(node) -> List[torch.fx.Node]:
    """The node's tensor operands, lists flattened, in order."""
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        for x in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(_val(x), torch.Tensor):
                out.append(x)
    return out


class _DepInterpreter:
    """Forward dependence propagation over one aten graph."""

    def __init__(self):
        self.evidence: List[str] = []

    def run(self, gm: torch.fx.GraphModule, in_deps: Sequence[Dep]):
        env: Dict[torch.fx.Node, Dep] = {}
        inputs = iter(in_deps)
        out = None
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(inputs, CONST)
            elif node.op == "call_function":
                env[node] = self._node(node, env)
            elif node.op == "output":
                out = node.args[0]
            else:                               # get_attr: a constant
                env[node] = CONST
        return torch.utils._pytree.tree_map(
            lambda x: env.get(x, CONST) if isinstance(x, torch.fx.Node)
            else CONST, out)

    def _global(self, why: str) -> Dep:
        self.evidence.append(why)
        return GLOBAL

    def _opaque(self, node, env, name: str) -> Dep:
        """Pure functions of CONST inputs stay CONST; anything touching
        row/global data degrades to GLOBAL."""
        if all(env.get(a, CONST) == CONST for a in node.all_input_nodes):
            return CONST
        return self._global(f"opaque op {name!r}")

    # -- per-node transfer ---------------------------------------------------
    def _node(self, node, env) -> Dep:
        target = node.target
        if target is operator.getitem:
            return env.get(node.args[0], CONST)
        if not isinstance(target, torch._ops.OpOverload):
            return self._opaque(node, env, str(target))
        name = _op_name(target)
        out_shape = _shape(node)
        a = _bound(node)
        x = node.args[0] if node.args else None
        dep = env.get(x, CONST) if isinstance(x, torch.fx.Node) else CONST
        in_shape = _shape(x)

        if name in _SOURCES:
            return CONST
        if torch.Tag.pointwise in target.tags or name in _IDENTITY \
                or name == "copy" or name == "where":
            return _join_elementwise(
                [(env.get(t, CONST), _shape(t)) for t in _tensor_args(node)],
                out_shape)
        if dep == CONST and name == "gather":
            idx = env.get(a["index"], CONST)       # a CONST table looked up
            if idx[0] == "row" and len(_shape(a["index"])) == len(in_shape) \
                    and _norm(int(a["dim"]), len(in_shape)) != idx[1]:
                return idx                         # by a row-wise index
        if dep[0] != "row":
            if name in _REDUCE | _CUMULATIVE | _SORT | _VIEW or name in (
                    "permute", "transpose", "t", "unsqueeze", "squeeze",
                    "expand", "slice", "select", "gather", "index_select"):
                if dep == CONST and any(
                        env.get(t, CONST) != CONST
                        for t in node.all_input_nodes if t is not x):
                    return self._opaque(node, env, str(target))
                return dep
        axis = dep[1]
        rank = len(in_shape)

        if name in _REDUCE:
            dims = a.get("dim")
            if dims is None or dims == [] or dims == ():
                dims = list(range(rank))
            elif isinstance(dims, int):
                dims = [dims]
            dims = sorted(_norm(int(d), rank) for d in dims)
            if axis in dims:
                return self._global(f"{name} reduces over the client axis "
                                    f"(dims={tuple(dims)})")
            if a.get("keepdim", False):
                return _row(axis)
            return _row(axis - sum(1 for d in dims if d < axis))

        if name in _CUMULATIVE:
            if _norm(int(a["dim"]), rank) == axis:
                return self._global(f"{name} scans along the client axis")
            return dep

        if name in _SORT:
            key = _join_elementwise(
                [(env.get(t, CONST), _shape(t)) for t in _tensor_args(node)],
                out_shape)
            if key[0] == "row" and _norm(int(a.get("dim", -1)), rank) == \
                    key[1]:
                return self._global(f"{name} along the client axis")
            return key

        if name in _VIEW:
            if target._overloadname == "dtype":
                return dep if axis != rank - 1 else self._global(
                    "view as another dtype folds the client axis")
            new_axis = _map_axis_through_reshape(in_shape, out_shape, axis)
            if new_axis is None:
                return self._global(f"{name} {in_shape}->{out_shape} folds "
                                    "the client axis")
            return _row(new_axis)

        if name == "permute":
            perm = [_norm(int(d), rank) for d in a["dims"]]
            return _row(perm.index(axis))
        if name in ("transpose", "t"):
            d0, d1 = ((0, 1) if name == "t" else
                      (_norm(int(a["dim0"]), rank),
                       _norm(int(a["dim1"]), rank)))
            return _row(d1 if axis == d0 else d0 if axis == d1 else axis)
        if name == "unsqueeze":
            d = _norm(int(a["dim"]), rank + 1)
            return _row(axis + (1 if d <= axis else 0))
        if name == "squeeze":
            dims = a.get("dim")
            if dims is None:
                dims = [i for i, e in enumerate(in_shape) if e == 1]
            elif isinstance(dims, int):
                dims = [dims]
            dims = [_norm(int(d), rank) for d in dims if in_shape[
                _norm(int(d), rank)] == 1]
            if axis in dims:
                return self._global("squeeze drops the client axis")
            return _row(axis - sum(1 for d in dims if d < axis))
        if name == "expand":
            return _row(axis + len(out_shape) - rank)
        if name == "slice":
            d = _norm(int(a.get("dim", 0)), rank)
            if d != axis:
                return dep
            start = a.get("start") or 0
            end = a.get("end")
            whole = (start in (0, None) and a.get("step", 1) == 1
                     and (end is None or end >= in_shape[d]))
            return dep if whole else self._global(
                "slice reindexes the client axis")
        if name == "select":
            d = _norm(int(a["dim"]), rank)
            if d == axis:
                return self._global("select picks one client row")
            return _row(axis - (1 if d < axis else 0))

        if name in ("select_scatter", "slice_scatter"):
            base, src = env.get(node.args[0], CONST), env.get(
                node.args[1], CONST)
            d = _norm(int(a.get("dim", 0)), rank)
            if base == CONST and src == CONST:
                return CONST
            if name == "select_scatter" and src[0] == "row":
                src = _row(src[1] + (1 if src[1] >= d else 0))
            joined = _join_elementwise([(base, in_shape), (src, in_shape)],
                                       out_shape)
            if joined[0] == "row" and joined[1] == d:
                return self._global(f"{name} writes along the client axis")
            return joined

        if name in ("cat", "stack"):
            parts = [(env.get(t, CONST), _shape(t))
                     for t in node.args[0] if isinstance(t, torch.fx.Node)]
            rank_in = len(parts[0][1]) if parts else 0
            d = _norm(int(a.get("dim", 0)), rank_in + (name == "stack"))
            if name == "stack":
                parts = [((_row(p[1] + (1 if p[1] >= d else 0))
                           if p[0] == "row" else p),
                          s[:d] + (1,) + s[d:]) for p, s in parts]
            joined = _join_elementwise(parts, out_shape)
            if joined[0] == "row" and joined[1] == d:
                return self._global(
                    f"{name} along the client axis breaks row alignment")
            return joined

        if name in ("gather", "index_select"):
            # Aligned when the row axis is not the gathered one and the
            # index is CONST or row-aligned on the same axis.
            d = _norm(int(a["dim"]), rank)
            idx = env.get(a["index"], CONST)
            if name == "gather" and len(_shape(a["index"])) != rank:
                idx = GLOBAL
            if name == "index_select" and idx != CONST:
                idx = GLOBAL
            if d != axis and idx in (CONST, dep):
                return dep
            return self._global(f"{name} reads across client rows")

        return self._opaque(node, env, str(target))


# ---------------------------------------------------------------------------
# The verdict
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeparabilityVerdict:
    """The analyzer's answer for one strategy.

    ``separable`` is the combined verdict; ``scores_dep`` the lattice tag of
    the scores output (``"const"``/``"row"``/``"global"``/``"unknown"``);
    ``mask_consistent`` the saturated-mask probe result (``None`` when the
    probe was skipped or the trace already failed); ``reasons`` the recorded
    evidence — the aten ops that promoted the scores to GLOBAL, or the trace
    error."""
    name: str
    separable: bool
    scores_dep: str
    mask_consistent: Optional[bool] = None
    reasons: Tuple[str, ...] = ()

    def summary(self) -> str:
        why = f" ({'; '.join(self.reasons)})" if self.reasons else ""
        return (f"{self.name}: scores={self.scores_dep}, "
                f"mask_probe={self.mask_consistent}{why}")


def _probe_hists(num_clients: int, num_classes: int,
                 device: torch.device) -> torch.Tensor:
    """Deterministic probe content: varied per-row histograms with nonzero
    label variance on most rows and two all-zero (invalid) rows, so both
    arms of every builtin validity gate are exercised."""
    i = np.arange(num_clients)[:, None]
    c = np.arange(num_classes)[None, :]
    h = ((3 * i + 7 * c + 1) % 5).astype(np.float32)
    h[1] = 0.0
    if num_clients > 5:
        h[5] = 0.0
    return torch.from_numpy(h).to(device)


def _mask_probe(fn: Callable, *, num_clients: int, num_classes: int,
                num_blocks: int, device: torch.device) -> Optional[bool]:
    """Saturated-mask block-consistency: at ``n_select = population`` the
    dense mask must equal the concatenation of per-block masks."""
    if num_clients % num_blocks:
        return None
    bs = num_clients // num_blocks
    key = rng.PRNGKey(7, device)
    hists = _probe_hists(num_clients, num_classes, device)
    try:
        dense = fn(key, hists, num_clients).mask
        parts = [fn(rng.fold_in(key, b), hists[b * bs:(b + 1) * bs], bs).mask
                 for b in range(num_blocks)]
        return bool(torch.equal(dense.cpu(), torch.cat(parts).cpu()))
    except Exception:
        return None


def classify_strategy(fn: Callable, *, num_clients: int = 32,
                      num_classes: int = 10, name: str = "",
                      probe: bool = True,
                      device: "str | torch.device | None" = None
                      ) -> SeparabilityVerdict:
    """Classify one registered strategy's block-separability.

    ``num_clients``/``num_classes`` set the trace shapes (the dependence
    structure is shape-stable for every known strategy, so callers gating
    huge populations classify at this canonical size).  ``probe=False``
    skips the concrete saturated-mask probe and answers from the graph
    alone.  ``device`` (``None``: the card) is where the fake tensors of
    the trace and the probe's tensors lie."""
    name = name or getattr(fn, "__name__", "strategy")
    dev = resolve_device(device)

    def wrapper(key, hists):
        r = fn(key, hists, num_clients)
        return r.scores, r.mask

    try:
        gm, trips = trace_graph(
            wrapper, torch.zeros(2, dtype=torch.int64, device=dev),
            torch.zeros(num_clients, num_classes, device=dev))
    except Exception as e:
        first = str(e).strip().split("\n")[0]
        return SeparabilityVerdict(name, False, "unknown", None,
                                   (f"trace failed: {first}",))
    return verdict_from_graph(fn, gm, trips, 0, name=name,
                              num_clients=num_clients,
                              num_classes=num_classes, probe=probe,
                              device=dev)


def verdict_from_graph(fn: Callable, gm: torch.fx.GraphModule,
                       trips: Dict[str, int], scores_output: int, *,
                       name: str, num_clients: int, num_classes: int,
                       probe: bool, device: torch.device
                       ) -> SeparabilityVerdict:
    """:func:`classify_strategy`'s verdict from a graph of ``fn(key, hists,
    n)`` already traced at (num_clients, num_classes) with inputs (key,
    hists), whose output ``scores_output`` is the scores (the contract pass
    reuses its own trace)."""
    if trips:
        return SeparabilityVerdict(
            name, False, "unknown", None,
            (f"host round trip ({', '.join(sorted(trips))}) hides the "
             "scores' dependence",))

    interp = _DepInterpreter()
    scores_dep = interp.run(gm, [CONST, _row(0)])[scores_output]
    # Evidence from GLOBAL promotions anywhere in the trace; only relevant
    # when the scores output itself went global.
    reasons = tuple(dict.fromkeys(interp.evidence))[:4]
    if scores_dep[0] == "row" and scores_dep[1] != 0:
        scores_dep = GLOBAL
        reasons = reasons + ("scores aligned to a non-client axis",)
    row_ok = scores_dep[0] in ("const", "row")
    if row_ok:
        reasons = ()

    mask_ok: Optional[bool] = None
    if probe:
        mask_ok = _mask_probe(fn, num_clients=num_clients,
                              num_classes=num_classes,
                              num_blocks=min(4, num_clients), device=device)
        if mask_ok is False:
            reasons = reasons + (
                "saturated-mask probe: dense mask != per-block masks",)

    separable = row_ok and mask_ok is not False
    return SeparabilityVerdict(name, separable, scores_dep[0], mask_ok,
                               reasons)
