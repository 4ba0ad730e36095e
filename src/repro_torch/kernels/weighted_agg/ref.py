"""Plain PyTorch version of the weighted client-sum kernel."""
from __future__ import annotations

import torch


def weighted_agg_ref(stacked: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """stacked (K, N), scales (K,) float32 -> (N,) sum_k s_k * stacked_k,
    accumulated in float32 and returned in ``stacked``'s dtype."""
    acc = (scales.float()[:, None] * stacked.float()).sum(0)
    return acc.to(stacked.dtype)
