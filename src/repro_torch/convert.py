"""Carry parameters between the reference's layout and the port's.

The reference keeps a nested dict of arrays (``{"conv1": {"w", "b"}, …}``)
with HWIO convolution kernels; the port keeps a flat ``dict[str, Tensor]``
(``"conv1.w"``, …) with OIHW kernels.  Dense weights are (in, out) in both.
Both functions take and give NumPy arrays on the reference's side, so neither
needs JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device


def params_from_jax(tree: Dict[str, Any],
                    device: "str | torch.device | None" = None
                    ) -> Dict[str, torch.Tensor]:
    """Nested reference params (array-likes, HWIO convs) -> flat port params
    on ``device`` (OIHW convs)."""
    device = resolve_device(device)
    out = {}
    for layer, leaves in tree.items():
        for name, value in leaves.items():
            a = np.asarray(value)
            if a.ndim == 4:  # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            out[f"{layer}.{name}"] = torch.from_numpy(np.array(a)).to(device)
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """Flat port params -> nested NumPy params in the reference's layout."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in params.items():
        layer, name = key.split(".", 1)
        a = value.detach().cpu().numpy()
        if a.ndim == 4:  # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        out.setdefault(layer, {})[name] = np.ascontiguousarray(a)
    return out
