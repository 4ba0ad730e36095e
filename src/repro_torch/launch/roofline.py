"""Roofline terms of a step, from its aten graph traced over fake tensors.

    compute    = FLOPs_per_device / peak bf16 FLOP/s          (s)
    memory     = bytes_per_device / HBM bandwidth             (s)
    collective = collective_bytes_per_device / NVLink each way (s)
    eager      = eager_bytes_per_device / HBM bandwidth       (s)

with the H100's constants (``launch.mesh``).  The reference
(``repro/launch/roofline.py``) reads XLA's ``cost_analysis`` and
``memory_analysis`` of the compiled program; the port reads the graph that
``launch.dryrun`` traces with ``make_fx`` over fake tensors, in which each
kernel launch is one ``repro_torch`` op:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``'s formula for
  each node's op, on the node's traced values (what the counter does for
  each op it sees, without running the graph again), with a formula
  registered here for each kernel op.  Each counts what the
  kernel's bound in PERF.md counts: attention's live causal or window
  (q, k) pairs, each product once (Q·Kᵀ and P·V: 4·D operations a pair and
  head); its backward 2.5× that (five products); the SSD scan's chunked
  products at the model's chunk (:func:`ssd_chunk`); the weighted sum
  2·K operations a column.  ``label_hist`` has none: it counts labels,
  an integer compare and add each, with no floating-point product, so its
  cost is the bytes it moves.
* **Bytes**, the memory term: the least the step must move, each input
  storage (params, optimizer state, batch, caches) read once, each output
  that is not an input written once, and each in-place write into an input
  (a cache update) its written bytes.  With the FLOPs it bounds the step's
  time from below, as a kernel row's bound does.
* **Eager bytes**, beside it: the sum over the graph's aten nodes of their
  input and output bytes, views and aliases excluded.  That is the eager
  program's traffic when every op reads its inputs from and writes its
  outputs to HBM; the caches can make the real traffic smaller.  It is
  not a bound on the step's time, and no roofline share is built on it.
* **Peak memory**: a liveness walk over the graph.  The inputs (params,
  optimizer state, batch, caches) are live throughout; every other storage
  is allocated by its first node and freed after its last use.  It is an
  estimate that ignores the caching allocator's rounding and reuse.
* **Collective bytes**: the output bytes of the graph's
  ``_c10d_functional`` collectives, an all-reduce counted twice (reduce and
  broadcast), as the reference counts them from the HLO.  A one-card step
  has none.

There is no scan-trip correction (the reference's ``correct_terms``): XLA
counts a ``lax.scan`` body once, while the eager trace unrolls every layer
and microbatch, so the graph's counts are the exact trip counts.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import flop_registry, register_flop_formula

# The kernels' ops must exist before their formulas are registered.
from .. import kernels as _kernels  # noqa: F401
from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# The graph's kernel ops, by name.
KERNEL_OPS = ("label_hist", "weighted_agg", "flash_attention",
              "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float              # the traced graph's, every trip
    bytes_per_device: float              # the least traffic (module note)
    collective_bytes_per_device: float
    collectives_by_kind: Dict[str, int]
    peak_memory_per_device: float
    model_flops: float  # 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode)
    eager_bytes_per_device: float        # every op's reads and writes

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_eager_memory(self) -> float:
        return self.eager_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / the graph's FLOPs summed over chips: what the step
        computes beyond 2 (or 6) operations a parameter and token."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives_by_kind": self.collectives_by_kind,
            "peak_memory_per_device": self.peak_memory_per_device,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "eager_bytes_per_device": self.eager_bytes_per_device,
            "t_eager_memory_s": self.t_eager_memory,
        }


def active_param_count(cfg) -> int:
    """Active params a token: all params less the experts a token does not
    route to."""
    from .steps import param_count
    n = param_count(cfg)
    if cfg.num_experts > 0:
        ff = cfg.moe_d_ff or cfg.d_ff
        per_expert = 3 * cfg.d_model * ff
        n_moe_layers = sum(1 for _, f in cfg.layer_kinds()
                           if f.startswith("moe"))
        inactive = (n_moe_layers * per_expert
                    * (cfg.num_experts - cfg.experts_per_token))
        n -= inactive
    return n


def model_flops_estimate(cfg, shape) -> float:
    """6·N_active·D to train; 2·N_active·D for a forward-only step
    (prefill); 2·N_active·B for one decode token."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# The kernels' FLOP formulas
# ---------------------------------------------------------------------------

_SSD_CHUNK: contextvars.ContextVar[int] = contextvars.ContextVar(
    "ssd_chunk", default=128)


@contextlib.contextmanager
def ssd_chunk(chunk: int) -> Iterator[None]:
    """Count the SSD scan's products at ``chunk`` (the model's
    ``ssm_chunk``; the kernel's op does not carry it, and 128 is
    mamba2-1.3b's)."""
    token = _SSD_CHUNK.set(int(chunk))
    try:
        yield
    finally:
        _SSD_CHUNK.reset(token)


def live_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs attention computes for a sequence of ``s``: all s² without
    the causal mask; with it, key j for query i where j ≤ i and, with a
    window, j > i − window."""
    if not causal:
        return s * s
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_flops(q_shape, causal: bool, window: int) -> int:
    """Q·Kᵀ and P·V once each: 4·D operations a live pair and q-head."""
    b, s, h, d = q_shape
    return 4 * b * h * d * live_pairs(s, causal, window)


def ssd_flops(x_shape, b_shape, chunk: int) -> int:
    """The chunked SSD form's products done once: per chunk C·Bᵀ shared by
    a group, then per head (C·Bᵀ∘L)·X, C·S_inᵀ and Xᵀ·B."""
    b, s, h, p = x_shape
    g, n = b_shape[2], b_shape[3]
    return 2 * b * s * (g * chunk * n + h * p * (chunk + 2 * n))


def ssd_bwd_flops(x_shape, b_shape, chunk: int) -> int:
    """The chunked SSD form's backward products done once: per chunk and
    group C·Bᵀ again, dS·B and dSᵀ·C (dS the gradient of C·Bᵀ, summed over
    the group's heads); per head and chunk dY·Xᵀ and the intra-chunk dX
    (chunk × chunk × P each), and the five (P × N) products of a chunk: Xᵀ·B
    for the entering states, B·Gᵀ for dX, X·G and dY·S_in for dB and dC, and
    (dY∘e^cum)ᵀ·C for the state gradient G."""
    b, s, h, p = x_shape
    g, n = b_shape[2], b_shape[3]
    return 2 * b * s * (3 * g * chunk * n + h * p * (2 * chunk + 5 * n))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flop(q, k, v, causal, window, with_lse, *,
                          out_shape=None, **kwargs) -> int:
    return attention_flops(q, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_attention_bwd_flop(q, k, v, o, lse, do, causal, window, *,
                              out_shape=None, **kwargs) -> int:
    # S = Q·Kᵀ recomputed, dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q.
    return 5 * attention_flops(q, causal, window) // 2


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_scan_flop(x, dt, A, B, C, *, out_shape=None, **kwargs) -> int:
    return ssd_flops(x, B, _SSD_CHUNK.get())


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _ssd_scan_bwd_flop(x, dt, A, B, C, gy, gfin, chunk, *, out_shape=None,
                       **kwargs) -> int:
    return ssd_bwd_flops(x, B, chunk)


@register_flop_formula(torch.ops.repro_torch.weighted_agg)
def _weighted_agg_flop(leaves, scales, denom, *, out_shape=None,
                       **kwargs) -> int:
    return sum(2 * math.prod(shape) for shape in leaves)


# ---------------------------------------------------------------------------
# Graph walks
# ---------------------------------------------------------------------------

def _val(x: Any) -> Any:
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else x


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _node_tensors(args: Any) -> List[torch.Tensor]:
    """The tensor values a node's args or output hold."""
    return _tensors(pytree.tree_map(_val, args))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(op: Any) -> bool:
    """An op whose every output aliases an input without writing it
    (``_unsafe_view``'s schema does not say so, but its output shares its
    input's storage)."""
    if op is torch.ops.aten._unsafe_view.default:
        return True
    rets = op._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _ops(gm: torch.fx.GraphModule) -> Iterator[torch.fx.Node]:
    for node in gm.graph.nodes:
        if node.op == "call_function" and isinstance(node.target,
                                                     torch._ops.OpOverload):
            yield node


def _storage(t: torch.Tensor):
    return StorageWeakRef(t.untyped_storage())


def _writes(node: torch.fx.Node) -> List[torch.Tensor]:
    """The tensors an in-place op writes (its mutable arguments)."""
    schema = node.target._schema
    out = []
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        val = (node.args[i] if i < len(node.args)
               else node.kwargs.get(arg.name))
        out += _node_tensors(val)
    return out


def min_bytes(gm: torch.fx.GraphModule) -> int:
    """The least bytes the graph must move: every input storage read once,
    every output storage that is not an input's written once, and each
    in-place write into an input's storage (a cache slot, a recurrent state)
    its written view's bytes."""
    inputs = {}
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            for t in _node_tensors(node):
                inputs[_storage(t)] = t.untyped_storage().nbytes()
    total = sum(inputs.values())
    for node in _ops(gm):
        total += sum(_nbytes(t) for t in _writes(node)
                     if _storage(t) in inputs)
    outputs = {}
    for t in _node_tensors(gm.graph.output_node().args):
        if _storage(t) not in inputs:
            outputs[_storage(t)] = t.untyped_storage().nbytes()
    return total + sum(outputs.values())


def eager_bytes(gm: torch.fx.GraphModule) -> int:
    """Σ over the aten nodes (views and aliases excluded) of their input and
    output tensors' bytes: the eager program's traffic with no cache."""
    total = 0
    for node in _ops(gm):
        if _is_view(node.target):
            continue
        total += sum(_nbytes(t) for t in _node_tensors((node.args,
                                                        node.kwargs)))
        total += sum(_nbytes(t) for t in _node_tensors(node))
    return total


def peak_memory(gm: torch.fx.GraphModule) -> int:
    """Bytes live at the graph's fullest point: the inputs' storages
    throughout, every other storage from the node that first produces it to
    its last use (the graph's outputs to the end)."""
    nodes = list(gm.graph.nodes)
    size: Dict[Any, int] = {}
    born: Dict[Any, int] = {}
    last: Dict[Any, int] = {}
    pinned = set()
    for i, node in enumerate(nodes):
        if node.op == "placeholder":
            for t in _node_tensors(node):
                ref = _storage(t)
                pinned.add(ref)
                size[ref] = t.untyped_storage().nbytes()
            continue
        if node.op == "output":
            for t in _node_tensors(node.args):
                last[_storage(t)] = len(nodes)
            continue
        for t in _node_tensors((node.args, node.kwargs)):
            last[_storage(t)] = max(last.get(_storage(t), i), i)
        for t in _node_tensors(node):
            ref = _storage(t)
            if ref not in size:
                size[ref] = t.untyped_storage().nbytes()
                born[ref] = i
            last[ref] = max(last.get(ref, i), i)
    freed: Dict[int, List[Any]] = {}
    for ref, i in last.items():
        if ref not in pinned:
            freed.setdefault(i, []).append(ref)
    born_at: Dict[int, List[Any]] = {}
    for ref, i in born.items():
        born_at.setdefault(i, []).append(ref)
    live = sum(size[r] for r in pinned)
    peak = live
    for i in range(len(nodes)):
        live += sum(size[r] for r in born_at.get(i, ()))
        peak = max(peak, live)
        live -= sum(size[r] for r in freed.get(i, ()))
    return peak


_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "irecv": "collective-permute",
}


def collective_bytes(gm: torch.fx.GraphModule) -> Dict[str, int]:
    """Output bytes of each kind of ``_c10d_functional`` collective in the
    graph (one rank's program), an all-reduce counted twice; a permute is a
    point-to-point receive (``irecv``)."""
    out = dict.fromkeys(COLLECTIVES, 0)
    for node in _ops(gm):
        if node.target.namespace != "_c10d_functional":
            continue
        kind = _COLLECTIVE_OPS.get(node.target._overloadpacket.__name__)
        if kind is not None:
            mult = 2 if kind == "all-reduce" else 1
            out[kind] += mult * sum(_nbytes(t) for t in _node_tensors(node))
    return out


def graph_flops(gm: torch.fx.GraphModule, chunk: int = 128
                ) -> Dict[str, int]:
    """``{"total", <kernel op>: its FLOPs}`` of ``gm``: each node's op
    counted by ``FlopCounterMode``'s formula for it (``flop_registry``,
    with the kernel ops' formulas above) on the node's traced values, as
    ``FlopCounterMode`` counts each op it sees, without running the graph
    again; the SSD scan counted at ``chunk``.  (A ``FlopCounterMode`` over a
    run of the graph gives the same sum, tests/test_torch_launch.py.)"""
    out = dict.fromkeys(("total",), 0)
    with ssd_chunk(chunk):
        for node in _ops(gm):
            packet = node.target._overloadpacket
            formula = flop_registry.get(packet)
            if formula is None:
                continue
            args, kwargs = pytree.tree_map(_val, (node.args, node.kwargs))
            n = int(formula(*args, **kwargs, out_val=_val(node)))
            out["total"] += n
            name = packet.__name__
            if name in KERNEL_OPS:
                out[name] = out.get(name, 0) + n
    return out


def extract_roofline(arch: str, shape, mesh_name: str, chips: int,
                     gm: torch.fx.GraphModule, cfg,
                     flops: Optional[float] = None) -> Roofline:
    """The :class:`Roofline` of a traced step (``launch.dryrun``);
    ``flops``, when given, is ``graph_flops(gm, cfg.ssm_chunk)["total"]``
    already counted."""
    colls = collective_bytes(gm)
    if flops is None:
        flops = graph_flops(gm, cfg.ssm_chunk)["total"]
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=float(flops),
        bytes_per_device=float(min_bytes(gm)),
        eager_bytes_per_device=float(eager_bytes(gm)),
        collective_bytes_per_device=float(sum(colls.values())),
        collectives_by_kind=colls,
        peak_memory_per_device=float(peak_memory(gm)),
        model_flops=model_flops_estimate(cfg, shape))


__all__ = ["COLLECTIVES", "KERNEL_OPS", "Roofline", "active_param_count",
           "attention_flops", "collective_bytes", "extract_roofline",
           "eager_bytes", "graph_flops", "live_pairs", "min_bytes",
           "model_flops_estimate", "peak_memory", "ssd_bwd_flops", "ssd_chunk",
           "ssd_flops"]
