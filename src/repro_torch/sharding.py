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

These are pure functions of the mesh's axis names and sizes: ``mesh`` is a
mapping ``{axis name: size}`` or a ``torch.distributed.DeviceMesh`` (its
``mesh_dim_names`` and ``shape``).  A spec is a tuple of mesh-axis entries
(a name, a tuple of names, or None), trailing Nones trimmed, where the
reference returns a ``PartitionSpec`` of the same entries.

Left out, because they place arrays on a multi-device mesh inside ``jit``:
``shardings_for``, ``tree_to_shardings``, ``shard_ctx``, ``constrain`` and
``tree_to_specs``.  The port runs one card, where nothing is placed, and its
multi-rank engine (``fl/sharded.py``) calls ``torch.distributed`` directly.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

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


__all__ = ["BATCH", "CLIENTS", "EMBED", "EXPERTS", "FF", "HEADS", "HEAD_DIM",
           "KV_HEADS", "KV_SEQ", "MOE_FF", "RESIDUAL_SEQ", "SEQ", "SSM_INNER",
           "SSM_STATE", "VOCAB", "logical_to_spec", "make_rules", "mesh_axes",
           "spec_for_shape"]
