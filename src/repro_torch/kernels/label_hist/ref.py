"""Plain PyTorch version of the per-client label-histogram kernel."""
from __future__ import annotations

import torch

from ...core.label_stats import histogram


def label_hist_ref(labels: torch.Tensor, valid: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """labels (B, n) int32, valid (B, n) bool -> (B, C) float32 counts;
    invalid entries and labels outside [0, C) count toward nothing."""
    return histogram(labels, num_classes, valid)
