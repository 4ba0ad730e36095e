"""Carry parameters between the reference's layout and the port's.

Both directions take and give NumPy arrays on the reference's side, so
neither needs JAX.  The layout rule belongs to the model:

* The CNN (``params_from_jax``/``params_to_jax``): the reference keeps a
  nested dict (``{"conv1": {"w", "b"}, …}``), the port a flat
  ``dict[str, Tensor]`` keyed by the dotted path (``"conv1.w"``), and each
  leaf named in ``models.cnn.REFERENCE_LAYOUT`` is transposed by the axis
  order given there (HWIO -> OIHW convolution kernels).  Leading stack axes
  ride along untouched: a clustered model's (M, …) leaves or the grid's
  (T, M, …) convert as one tree.
* The LM stack (``lm_params_from_jax``/``lm_params_to_jax``): leaves keep the
  reference's layout; the reference's stacked blocks (``scan_layers``: each
  leaf of block j carries a leading repeat axis, ``transformer.stack_plan``)
  become the port's per-layer list, layer ``r * period + j`` = repeat r of
  block j, and back.  ``flat=True`` gives the flat dotted form the ``lm``
  FL workload carries (``transformer.flatten_params``), which
  ``lm_params_to_jax`` also takes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from .device import resolve_device
from .models.cnn import REFERENCE_LAYOUT as CNN_LAYOUT
from .models.config import ModelConfig
from .models.transformer import flatten_params, stack_plan, unflatten_params


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "."))
        else:
            out[path] = value
    return out


def _stacked(perm, ndim: int):
    """``perm`` applied to the trailing ``len(perm)`` axes of an ``ndim``
    array, its leading (stack) axes kept in place."""
    lead = ndim - len(perm)
    if lead < 0:
        raise ValueError(f"a leaf of rank {ndim} cannot take the rank-"
                         f"{len(perm)} layout {tuple(perm)}")
    return tuple(range(lead)) + tuple(lead + int(i) for i in perm)


def _leaf_to_torch(value: Any, device: torch.device) -> torch.Tensor:
    """One reference leaf (an array-like) -> a tensor on ``device`` with its
    bits.  NumPy has no bfloat16 of its own: the reference's bf16 leaves
    come as ``ml_dtypes.bfloat16`` arrays, whose raw 16-bit words are viewed
    as ``torch.bfloat16``."""
    a = np.array(np.asarray(value))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One port leaf -> a NumPy array with its bits; bf16 becomes the
    reference's ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return np.ascontiguousarray(
            t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return np.ascontiguousarray(t.numpy())


def params_from_jax(tree: Mapping[str, Any],
                    device: "str | torch.device | None" = None
                    ) -> Dict[str, torch.Tensor]:
    """Nested reference CNN params (array-likes, any depth) -> flat port
    params on ``device``, each leaf named in the CNN's layout transposed to
    the port's axis order behind any leading stack axes."""
    device = resolve_device(device)
    out = {}
    for path, value in _flatten(tree).items():
        a = np.asarray(value)
        if path in CNN_LAYOUT:
            a = a.transpose(_stacked(CNN_LAYOUT[path], a.ndim))
        out[path] = _leaf_to_torch(a, device)
    return out


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat port CNN params (any leading stack axes) -> nested NumPy params
    in the reference's layout."""
    out: Dict[str, Any] = {}
    for path, value in params.items():
        a = _leaf_to_numpy(value)
        if path in CNN_LAYOUT:
            a = a.transpose(_stacked(np.argsort(CNN_LAYOUT[path]), a.ndim))
        *parents, name = path.split(".")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)
    return out


def _to_torch(node: Any, device: torch.device) -> Any:
    if isinstance(node, Mapping):
        return {k: _to_torch(v, device) for k, v in node.items()}
    return _leaf_to_torch(node, device)


def _to_numpy(node: Any) -> Any:
    if isinstance(node, Mapping):
        return {k: _to_numpy(v) for k, v in node.items()}
    return _leaf_to_numpy(node)


def _take(node: Any, r: int) -> Any:
    """Repeat r of a stacked block tree."""
    if isinstance(node, Mapping):
        return {k: _take(v, r) for k, v in node.items()}
    return np.asarray(node)[r]


def _stack(nodes: List[Any]) -> Any:
    if isinstance(nodes[0], Mapping):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return np.stack(nodes)


def lm_params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                       device: "str | torch.device | None" = None,
                       flat: bool = False) -> Dict[str, Any]:
    """Reference LM params (``repro.models.init_model``'s tree as array-likes)
    -> the port's params on ``device``, with ``stack.blocks`` a per-layer
    list (or, with ``flat``, the ``lm`` workload's flat dotted form)."""
    device = resolve_device(device)
    _, period, reps = stack_plan(cfg)
    blocks = tree["stack"]["blocks"]
    if len(blocks) != period:
        raise ValueError(f"expected {period} stacked block trees for "
                         f"{cfg.name}; got {len(blocks)}")
    layers = [blocks[j] if reps == 1 else _take(blocks[j], r)
              for r in range(reps) for j in range(period)]
    out = {k: _to_torch(v, device) for k, v in tree.items() if k != "stack"}
    out["stack"] = {"blocks": [_to_torch(b, device) for b in layers]}
    return flatten_params(out) if flat else out


def lm_params_to_jax(params: Mapping[str, Any], cfg: ModelConfig
                     ) -> Dict[str, Any]:
    """The port's LM params (nested, or the ``lm`` workload's flat form) ->
    NumPy params in the reference's layout, the blocks restacked on their
    leading repeat axis as ``scan_layers`` asks."""
    if "stack" not in params:
        params = unflatten_params(dict(params))
    _, period, reps = stack_plan(cfg)
    layers = [_to_numpy(b) for b in params["stack"]["blocks"]]
    if len(layers) != period * reps:
        raise ValueError(f"expected {period * reps} layers for {cfg.name}; "
                         f"got {len(layers)}")
    blocks = tuple(layers[j] if reps == 1 else
                   _stack([layers[r * period + j] for r in range(reps)])
                   for j in range(period))
    out = {k: _to_numpy(v) for k, v in params.items() if k != "stack"}
    out["stack"] = {"blocks": blocks}
    return out
