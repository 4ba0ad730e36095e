"""Plain PyTorch version of the weighted client-sum kernel."""
from __future__ import annotations

from typing import Optional

import torch


def weighted_agg_ref(stacked: torch.Tensor, scales: torch.Tensor,
                     denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """stacked (K, N), scales (K,) float32 -> (N,) sum_k s_k * stacked_k,
    accumulated in float32, divided by ``denom`` in float32 when given, and
    returned in ``stacked``'s dtype.  With a trial axis, stacked (T, K, N),
    scales (T, K) and denom (T,) -> (T, N): each trial is the one-trial sum,
    computed alone, so the two forms agree bit for bit."""
    if scales.dim() == 2:
        return torch.stack([
            weighted_agg_ref(stacked[t], scales[t],
                             None if denom is None else denom[t])
            for t in range(scales.shape[0])])
    acc = (scales.float()[:, None] * stacked.float()).sum(0)
    if denom is not None:
        acc = acc / denom
    return acc.to(stacked.dtype)
