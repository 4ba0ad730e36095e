"""Histogram and the derived Algorithm-1 statistic in one call.

Mirrors ``repro/kernels/label_hist/ops.py``: always the kernel's wrapper, so
a CUDA tensor launches ``csrc/label_hist.cu`` (or raises) and a CPU tensor
takes the plain version, the port's counterpart of the reference's
``interpret=True``.  The engines route through the dispatched
``repro_torch.kernels.client_statistics`` (``kernels.dispatch``), which the
package exports.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.label_stats import label_variance_normed
from .label_hist import label_hist_kernel


def client_statistics(labels: torch.Tensor, num_classes: int = 10
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n) ragged labels (−1 pad) → (hists (B, C), σ²/n scores (B,))."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).to(torch.int32).contiguous()
    hists = label_hist_kernel(safe, valid.contiguous(), num_classes)
    return hists, label_variance_normed(hists)
