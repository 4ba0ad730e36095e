"""The public FedAvg wrapper over the weighted-sum kernel (mirrors
``repro/kernels/weighted_agg/ops.py``): the masked, normalised weights of
the clients and the weighted mean of every leaf of a stacked tree in one
launch."""
from __future__ import annotations

from typing import Dict

import torch

from .weighted_agg import weighted_agg_leaves

Params = Dict[str, torch.Tensor]


def normalized_scales(weights: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """(K,) float32 ``weights · mask / max(Σ weights · mask, 1e-12)``."""
    w = (weights * mask).to(torch.float32)
    return w / torch.clamp(w.sum(), min=1e-12)


def aggregate_params(stacked_params: Params, weights: torch.Tensor,
                     mask: torch.Tensor) -> Params:
    """FedAvg over the leading client axis of every leaf: ``Σ_k s_k θ_k``
    with ``s = normalized_scales(weights, mask)``, accumulated in float32
    and returned in each leaf's dtype.  The whole tree is one
    :func:`weighted_agg_leaves` call (one launch on the card; on CPU
    tensors the plain version).  The reference's ``interpret`` flag has no
    counterpart: the tensors' device decides."""
    scales = normalized_scales(weights, mask)
    flats = [p.reshape(p.shape[0], -1) for p in stacked_params.values()]
    sums = weighted_agg_leaves(flats, scales)
    return {k: s.reshape(p.shape[1:]).to(p.dtype)
            for (k, p), s in zip(stacked_params.items(), sums)}
