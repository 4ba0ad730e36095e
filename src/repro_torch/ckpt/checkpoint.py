"""Flat-npz checkpoints: a tree's leaves keyed by path, a JSON sidecar.

The reference's file format (``repro/ckpt/checkpoint.py``), so that files
cross between the stacks: ``ckpt_{step:08d}.npz`` holds one array a leaf,
keyed by the leaf's path with ``/`` between levels (a dict's key, a list's
index), and ``ckpt_{step:08d}.json`` holds ``{"step", "extra"}``.  npz has no
bfloat16, so a bf16 leaf is stored as its 16-bit words (uint16) under the key
prefixed ``__bf16__`` and viewed back on load.

The two stacks' trees differ in layout, so a file crosses through the
converter of its model (``repro_torch.convert``): :func:`read_checkpoint`
gives a reference file's arrays as a nested NumPy tree for
``lm_params_from_jax`` or ``params_from_jax``, and ``save_checkpoint(dir,
step, lm_params_to_jax(params, cfg))`` (or ``params_to_jax``) writes a file
the reference loads.  The port's own params load with
:func:`load_checkpoint` against a template of the same tree.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

Tree = Any

_BF16_TAG = "__bf16__"


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(node: Any):
    return node.items() if isinstance(node, dict) else enumerate(node)


def flatten_with_paths(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves of nested dicts, lists and tuples keyed by their ``/``-joined
    path (``stack/blocks/0/attn/wq``), the reference's keys."""
    out: Dict[str, Any] = {}
    for key, value in _children(tree):
        path = f"{prefix}{key}"
        if _is_node(value):
            out.update(flatten_with_paths(value, path + "/"))
        else:
            out[path] = value
    return out


def _map_with_paths(fn: Callable[[str, Any], Any], tree: Tree,
                    prefix: str = "") -> Tree:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, containers
    kept."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_paths(fn, v, f"{prefix}{i}/")
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return fn(prefix[:-1], tree)


def _stored(leaf: Any) -> Tuple[bool, np.ndarray]:
    """(is bf16, the array to store): a bf16 leaf (a torch tensor, or the
    reference's ``ml_dtypes.bfloat16`` array) as its 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return True, t.view(torch.int16).numpy().view(np.uint16)
        return False, t.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return True, a.view(np.uint16)
    return False, a


def _path(directory: str, step: int, ext: str) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.{ext}")


def save_checkpoint(directory: str, step: int, params: Tree,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``params`` (nested dicts/lists of tensors or arrays, any
    device) as ``directory/ckpt_{step:08d}.npz`` with its ``.json`` sidecar
    ``{"step": step, "extra": extra or {}}``; returns the npz path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    for key, leaf in flatten_with_paths(params).items():
        bf16, arr = _stored(leaf)
        arrays[(_BF16_TAG + key) if bf16 else key] = arr
    path = _path(directory, step, "npz")
    np.savez(path, **arrays)
    with open(_path(directory, step, "json"), "w") as f:
        json.dump({"step": step, "extra": extra or {}}, f)
    return path


def _meta(path: str) -> Dict[str, Any]:
    meta_path = path.replace(".npz", ".json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _raw(path: str) -> Dict[str, Tuple[bool, np.ndarray]]:
    """The file's arrays by key: (stored as bf16 words, array)."""
    with np.load(path) as data:
        return {(k[len(_BF16_TAG):] if k.startswith(_BF16_TAG) else k):
                (k.startswith(_BF16_TAG), data[k]) for k in data.files}


def read_checkpoint(path: str) -> Tuple[Tree, Dict[str, Any]]:
    """A checkpoint's arrays as a nested NumPy tree (a level whose keys are
    all indices becomes a list; bf16 words become ``ml_dtypes.bfloat16``,
    the reference's bf16), and its sidecar: a reference file, for the
    converters of ``repro_torch.convert``."""
    tree: Dict[str, Any] = {}
    for key, (bf16, arr) in _raw(path).items():
        if bf16:
            import ml_dtypes
            arr = arr.view(ml_dtypes.bfloat16)
        *parents, name = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree), _meta(path)


def load_checkpoint(path: str, template: Tree,
                    device: "str | torch.device | None" = None
                    ) -> Tuple[Tree, Dict[str, Any]]:
    """Restore ``path`` into the structure of ``template`` (nested dicts and
    lists of tensors, real or on the ``meta`` device) on ``device`` (None:
    the card).  Every leaf of the template must be in the file with the
    template's shape and dtype; a missing leaf or a mismatch raises.
    Returns (params, the sidecar's ``{"step", "extra"}``)."""
    device = resolve_device(device)
    raw = _raw(path)

    def leaf(key: str, tmpl: Any) -> torch.Tensor:
        if key not in raw:
            raise KeyError(f"{path} has no leaf {key!r}")
        bf16, arr = raw[key]
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if bf16 else torch.from_numpy(arr))
        if tuple(t.shape) != tuple(tmpl.shape) or t.dtype != tmpl.dtype:
            raise ValueError(f"{path}: leaf {key!r} is {t.dtype} "
                             f"{tuple(t.shape)}, the template's "
                             f"{tmpl.dtype} {tuple(tmpl.shape)}")
        return t.to(device)

    return _map_with_paths(leaf, template), _meta(path)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The npz of the highest step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory)
                   if re.match(r"ckpt_\d+\.npz$", f))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


__all__ = ["flatten_with_paths", "latest_checkpoint", "load_checkpoint",
           "read_checkpoint", "save_checkpoint"]
