"""Logical-axis -> mesh-axis sharding rules (MaxText-style, minimal): the
port's copy of ``repro/sharding.py``'s rule tables.

Params, caches and batches are annotated with *logical* axis names; a rule
table maps those to mesh axes for a mesh.  One table serves both production
meshes (``pod`` enters the rules only where the mesh has it), and
``spec_for_shape`` drops any entry that does not divide its dimension.

Train-mode rules are Megatron tensor parallelism (heads/ff/vocab/experts over
``model``), ZeRO-style FSDP (weight rows over ``data``) and data-parallel
batches over (``pod``, ``data``).  Decode-mode rules also shard the KV cache's
*sequence* dimension over ``model`` (flash-decoding style), since the cache
is the dominant memory term of one-token steps.

The rule tables are pure functions of the mesh's axis names and sizes:
``mesh`` is a mapping ``{axis name: size}`` or a ``torch.distributed``
``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``).  A spec is a tuple of
mesh-axis entries (a name, a tuple of names, or None), trailing Nones
trimmed, where the reference returns a ``PartitionSpec`` of the same
entries.

Placement over a ``DeviceMesh`` (``launch.mesh.make_debug_mesh``): the
reference pins shardings inside ``jit`` and GSPMD inserts the collectives;
the port runs one process a card and calls them itself.  What it places is
data parallelism with ZeRO-style FSDP over the ``data`` axis:

* ``shardings_for``/``tree_to_shardings``/``tree_to_specs`` give a spec
  tree, as the reference's do; ``ParamLayout`` reads from it the dimension
  each weight's ``EMBED`` axis splits over ``data`` (None: replicated), and
  shards and gathers a flat param tree exactly.
* Inside ``shard_ctx(mesh, rules)`` a rank holds its own rows of every
  activation (``BATCH`` over ``data``), so ``constrain`` is the identity on
  them; it raises where the rules would split an activation over a
  ``model`` axis, or ``RESIDUAL_SEQ``, of more than one card (tensor and
  sequence parallelism are not ported).
* ``gather`` all-gathers a weight bound by ``bind_shards`` where it is used
  (its backward reduce-scatters the gradient), and ``sum_over_ranks`` sums
  a loss term over the ranks, each rank's graph keeping its own share of
  the gradient.  Outside a shard context both are the identity, so the
  one-card paths and the FL engines' ``vmap(grad)`` never meet a collective.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import torch

# Logical axis vocabulary.
BATCH = "batch"            # global batch / clients
SEQ = "seq"                # sequence (activations)
KV_SEQ = "kv_seq"          # KV-cache sequence (decode)
EMBED = "embed"            # d_model rows of weight matrices (FSDP candidate)
VOCAB = "vocab"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
FF = "ff"
EXPERTS = "experts"
MOE_FF = "moe_ff"          # per-expert hidden dim (experts already take `model`)
SSM_INNER = "ssm_inner"    # mamba d_inner columns
SSM_STATE = "ssm_state"
RESIDUAL_SEQ = "residual_seq"  # seq dim of the saved residual stream (SP)
CLIENTS = "clients"        # FL client axis (pod-scale rounds)

Spec = Tuple[Any, ...]


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a mapping or a ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"need a mapping of axis sizes or a named DeviceMesh; "
                        f"got {type(mesh).__name__}")
    return {str(n): int(s) for n, s in zip(names, mesh.shape)}


def make_rules(mesh: Any, mode: str = "train", fsdp: bool = True,
               kv_policy: str = "seq", tp: bool = True,
               seq_parallel: bool = False) -> Dict[str, Any]:
    """Rule table for ``mesh``.  mode ∈ {train, prefill, decode}.

    ``kv_policy`` (the serving modes) picks which KV-cache axis takes
    ``model``: 'seq' (sequence sharding, for any kv_heads count) or 'heads'
    (head sharding, useful only where kv_heads divides the model axis).
    Without ``tp`` the ``model`` axis joins data parallelism."""
    names = set(mesh_axes(mesh))
    has_pod = "pod" in names
    batch_axes: Tuple[str, ...] = ("pod", "data") if has_pod else ("data",)
    if not tp:
        batch_axes = batch_axes + ("model",)
    # Prefill builds the decode-resident cache, so both serving modes shard
    # the cache the same way.
    caching = mode in ("decode", "prefill")
    return {
        BATCH: batch_axes,
        SEQ: None,
        KV_SEQ: ("model" if (caching and kv_policy == "seq" and tp) else None),
        EMBED: "data" if fsdp else None,
        VOCAB: "model" if tp else None,
        HEADS: "model" if tp else None,
        # The cache spec may name `model` only once: sequence XOR heads.
        KV_HEADS: (("model" if kv_policy == "heads" else None) if caching
                   else "model") if tp else None,
        HEAD_DIM: None,
        FF: "model" if tp else None,
        EXPERTS: "model" if tp else None,
        MOE_FF: None,
        SSM_INNER: "model" if tp else None,
        SSM_STATE: None,
        RESIDUAL_SEQ: "model" if (seq_parallel and tp) else None,
        CLIENTS: "pod" if has_pod else "data",
    }


def _trim(parts: list) -> Spec:
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def logical_to_spec(axes: Sequence["str | None"],
                    rules: Mapping[str, Any]) -> Spec:
    """A tuple of logical axis names -> a spec of mesh-axis entries."""
    return _trim([None if ax is None else rules.get(ax, None) for ax in axes])


def _axis_size(sizes: Mapping[str, int], entry: Any) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for e in entry:
            n *= sizes[e]
        return n
    return sizes[entry]


def spec_for_shape(shape: Sequence[int], axes: Sequence["str | None"],
                   mesh: Any, rules: Mapping[str, Any]) -> Spec:
    """As :func:`logical_to_spec`, dropping any mesh entry whose size does
    not divide its dimension (replication is the fallback: 8 KV heads on a
    16-way model axis, or a batch of 1 on the data axis)."""
    sizes = mesh_axes(mesh)
    parts = []
    for dim, ax in zip(shape, axes):
        entry = rules.get(ax, None) if ax is not None else None
        if entry is not None and dim % _axis_size(sizes, entry) != 0:
            entry = None
        parts.append(entry)
    return _trim(parts)


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------

def is_axes_tuple(x) -> bool:
    """True for a logical-axes leaf: a (possibly empty) tuple of names/None."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def _map_axes(fn: Callable, logical: Any, *trees: Any) -> Any:
    """``fn(axes, *leaves)`` over a logical-axes tree (nested dicts, lists
    and tuples whose leaves are axes tuples or None) and any trees of the
    same structure."""
    if logical is None or is_axes_tuple(logical):
        return fn(logical, *trees)
    if isinstance(logical, Mapping):
        return {k: _map_axes(fn, v, *(t[k] for t in trees))
                for k, v in logical.items()}
    if isinstance(logical, (list, tuple)):
        return type(logical)(_map_axes(fn, v, *(t[i] for t in trees))
                             for i, v in enumerate(logical))
    raise TypeError(f"bad axes leaf {logical!r}")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as the reference's ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: Spec

    def dim_of(self, axis: str) -> Optional[int]:
        """The tensor dimension that mesh axis ``axis`` splits, or None."""
        for dim, entry in enumerate(self.spec):
            if entry == axis or (isinstance(entry, tuple) and axis in entry):
                return dim
        return None


def shardings_for(abstract: Any, logical: Any, mesh: Any,
                  rules: Mapping[str, Any]) -> Any:
    """Shape-aware ``NamedSharding``s for ``abstract`` (a tree of anything
    with a ``shape``: ``meta`` tensors) annotated by the matching
    ``logical`` axes tree; axes shorter than a leaf's rank are padded with
    None."""
    def one(axes, leaf):
        shape = tuple(leaf.shape)
        axes = (tuple(axes or ()) + (None,) * len(shape))[:len(shape)]
        return NamedSharding(mesh, spec_for_shape(shape, axes, mesh, rules))

    return _map_axes(one, logical, abstract)


def tree_to_shardings(logical_tree: Any, mesh: Any,
                      rules: Mapping[str, Any]) -> Any:
    """A tree of logical-axis tuples -> ``NamedSharding``s on ``mesh``."""
    return _map_axes(lambda axes: NamedSharding(
        mesh, logical_to_spec(axes, rules)), logical_tree)


def tree_to_specs(logical_tree: Any, rules: Mapping[str, Any]) -> Any:
    """The same, as raw specs."""
    return _map_axes(lambda axes: logical_to_spec(axes, rules), logical_tree)


# ---------------------------------------------------------------------------
# FSDP: each weight's EMBED dimension split over the `data` axis
# ---------------------------------------------------------------------------

def _group_size(group) -> int:
    return 1 if group is None else torch.distributed.get_world_size(group)


def _group_rank(group) -> int:
    return 0 if group is None else torch.distributed.get_rank(group)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``dim`` concatenated in rank order: gathered
    as (G, *block), then one copy into place (none for dim 0)."""
    from .core.aggregation import all_gather_tiled
    out = all_gather_tiled(x.contiguous()[None], group)
    shape = list(x.shape)
    shape[dim] *= out.shape[0]
    return out.movedim(0, dim).reshape(shape)


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over the ranks, each keeping its block of ``dim``:
    one copy into (G, *block) (none for dim 0), then the reduce-scatter."""
    from .core.aggregation import reduce_scatter_tiled
    g = _group_size(group)
    blocks = x.unflatten(dim, (g, x.shape[dim] // g)).movedim(dim, 0)
    return reduce_scatter_tiled(blocks.contiguous(), group)[0]


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Where a flat param tree's leaves live on the ``data`` ranks of
    ``group``: ``dims[name]`` is the dimension of leaf ``name`` (full shape
    ``shapes[name]``) whose contiguous blocks the ranks hold, rank g block
    g; None keeps the whole leaf on every rank."""
    dims: Dict[str, Optional[int]]
    shapes: Dict[str, Tuple[int, ...]]
    group: Any = None

    @property
    def size(self) -> int:
        return _group_size(self.group)

    @property
    def rank(self) -> int:
        return _group_rank(self.group)

    @property
    def sharded(self) -> frozenset:
        return frozenset(k for k, d in self.dims.items() if d is not None)

    def shard_leaf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``x`` (a copy, so that the
        whole can be freed), or ``x`` itself where it is replicated."""
        if tuple(x.shape) != self.shapes[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, the layout "
                             f"has {self.shapes[name]}")
        dim = self.dims[name]
        if dim is None:
            return x
        return x.chunk(self.size, dim)[self.rank].clone()

    def shard(self, flat: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        return {k: self.shard_leaf(k, x) for k, x in flat.items()}

    def gather_leaf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        dim = self.dims[name]
        return x if dim is None else _gather_dim(x, dim, self.group)

    def gather(self, flat: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The whole leaves from every rank's blocks (on every rank)."""
        return {k: self.gather_leaf(k, x) for k, x in flat.items()}


def param_layout(shapes: Mapping[str, Sequence[int]],
                 specs: Mapping[str, Any], mesh: Any,
                 rules: Mapping[str, Any], group: Any = None) -> ParamLayout:
    """The layout of flat leaves of ``shapes`` annotated by the flat
    logical ``specs`` (same keys, same order): a leaf is split on the
    dimension that ``spec_for_shape`` gives the ``data`` axis (its
    ``EMBED`` axis when the rules' FSDP is on and the mesh's ``data`` size
    divides it), else replicated."""
    dims, full = {}, {}
    for name, shape in shapes.items():
        shape = tuple(int(s) for s in shape)
        axes = (tuple(specs[name] or ()) + (None,) * len(shape))[:len(shape)]
        dims[name] = NamedSharding(
            mesh, spec_for_shape(shape, axes, mesh, rules)).dim_of("data")
        full[name] = shape
    return ParamLayout(dims, full, group)


# ---------------------------------------------------------------------------
# The shard context: activation constraints, gathers and global sums
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Context:
    mesh: Any
    rules: Mapping[str, Any]
    sizes: Dict[str, int]
    group: Any
    bound: Dict[int, Tuple[torch.Tensor, int]] = dataclasses.field(
        default_factory=dict)


_ACTIVE: List[_Context] = []


def data_group_of(mesh: Any):
    """The process group of a ``DeviceMesh``'s ``data`` axis.  None for a
    mapping of axis sizes (rules only, nothing to call), and for a ``data``
    axis of one rank: there every collective is the identity, so the mesh
    step runs the one-card program, bit for bit and at its cost."""
    if isinstance(mesh, Mapping) or mesh_axes(mesh).get("data", 1) == 1:
        return None
    return mesh.get_group("data")


@contextlib.contextmanager
def shard_ctx(mesh: Any, rules: Mapping[str, Any]) -> Iterator[None]:
    """Run the model code inside as one rank of ``mesh`` under ``rules``."""
    _ACTIVE.append(_Context(mesh, rules, mesh_axes(mesh),
                            data_group_of(mesh)))
    try:
        yield
    finally:
        _ACTIVE.pop()


def constrain(x: torch.Tensor, *logical_axes: "str | None") -> torch.Tensor:
    """``x`` itself: a rank holds its own rows of an activation.  Raises if
    the active rules would split one of ``logical_axes`` over a ``model``
    axis, or over ``RESIDUAL_SEQ``, of more than one card."""
    if not _ACTIVE:
        return x
    ctx = _ACTIVE[-1]
    for ax, entry in zip(logical_axes, logical_to_spec(logical_axes,
                                                       ctx.rules)):
        names = entry if isinstance(entry, tuple) else (entry,)
        if entry is None or _axis_size(ctx.sizes, entry) == 1:
            continue
        if "model" in names or ax == RESIDUAL_SEQ:
            raise NotImplementedError(
                f"activation axis {ax!r} on mesh axes {entry!r} of size "
                f"{_axis_size(ctx.sizes, entry)}: tensor and sequence "
                f"parallelism are not ported")
    return x


def data_group():
    """The active shard context's ``data`` group, or None."""
    return _ACTIVE[-1].group if _ACTIVE else None


def bind_shards(leaves: Mapping[str, torch.Tensor],
                layout: ParamLayout) -> None:
    """Make the active context's :func:`gather` gather ``leaves`` (this
    rank's blocks, the very tensor objects the model code will read) along
    their ``layout`` dimension; replaces what was bound before.  One rank
    holds every block whole, so nothing is bound there."""
    ctx = _ACTIVE[-1]
    ctx.bound = {id(x): (x, layout.dims[k]) for k, x in leaves.items()
                 if layout.dims[k] is not None and layout.size > 1}


class _GatherShard(torch.autograd.Function):
    """All-gather of a rank's block along ``dim``; the backward sums the
    whole gradient over the ranks and keeps the rank's block
    (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter_dim(dy, ctx.dim, ctx.group), None, None


def gather(x: torch.Tensor) -> torch.Tensor:
    """The whole weight of a bound shard (see :func:`bind_shards`); any
    other tensor, or any tensor outside a shard context, itself."""
    if not _ACTIVE:
        return x
    ctx = _ACTIVE[-1]
    hit = ctx.bound.get(id(x))
    if hit is None or hit[0] is not x:
        return x
    return _GatherShard.apply(x, hit[1], ctx.group)


def gather_tree(tree: Any) -> Any:
    """:func:`gather` over the leaves of a nested dict/list of tensors."""
    if isinstance(tree, Mapping):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_tree(v) for v in tree]
    return gather(tree)


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``x`` over the ranks; the backward passes the gradient
    through unchanged.  Every rank adds the same sum to its loss, so each
    rank's graph carries the gradient of the sum with respect to its own
    term, and the ranks' gradients summed (the FSDP reduce-scatter, the
    replicated leaves' all-reduce) are the gradient of the global loss."""

    @staticmethod
    def forward(ctx, x, group):
        from .core.aggregation import all_reduce_sum
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active context's ``data`` ranks (see
    ``_SumOverRanks`` for its gradient); ``x`` itself outside one."""
    group = data_group()
    return x if group is None else _SumOverRanks.apply(x, group)


def rank_count() -> int:
    """The number of ``data`` ranks of the active context (1 outside)."""
    return _group_size(data_group())


def rank_index() -> int:
    """This process's rank on the active context's ``data`` axis (0
    outside)."""
    return _group_rank(data_group())


__all__ = ["BATCH", "CLIENTS", "EMBED", "EXPERTS", "FF", "HEADS", "HEAD_DIM",
           "KV_HEADS", "KV_SEQ", "MOE_FF", "NamedSharding", "ParamLayout",
           "RESIDUAL_SEQ", "SEQ", "SSM_INNER", "SSM_STATE", "VOCAB",
           "bind_shards", "constrain", "data_group", "data_group_of",
           "gather", "gather_tree", "is_axes_tuple", "logical_to_spec",
           "make_rules", "mesh_axes", "param_layout", "rank_count",
           "rank_index", "shard_ctx", "shardings_for", "spec_for_shape",
           "sum_over_ranks", "tree_to_shardings", "tree_to_specs"]
