"""Label-wise clustering topology (paper §IV-A/B): the pieces the selection
strategies use.

Clusters are label-membership sets C_k = {clients i : class k ∈ ℒ_i}; their
intersection pattern partitions clients into areas A_p, whose index counts
down with coverage (A_1 = clients holding every label in play).  The k-means
of clustered FL comes with the clustered slice of the port.
"""
from __future__ import annotations

import torch

from .label_stats import coverage, label_variance_normed


def area_index(hists: torch.Tensor,
               num_active_labels: "torch.Tensor | int | None" = None
               ) -> torch.Tensor:
    """A_p index per client: p = q − coverage_i + 1 (A_1 = full coverage).

    ``num_active_labels`` q defaults to the number of classes present anywhere
    in this round's client population."""
    cov = coverage(hists)
    if num_active_labels is None:
        num_active_labels = (hists > 0).any(dim=-2).sum(-1, keepdim=True)
    q = torch.as_tensor(num_active_labels, dtype=torch.int32,
                        device=hists.device)
    return (q - cov + 1).to(torch.int32)


def selection_priority(hists: torch.Tensor) -> torch.Tensor:
    """Total-order key for A_1 > A_2 > … with the Eq. (3) tie-break: coverage
    scaled past any σ²/n term (σ² of C rank values is below C²)."""
    cov = coverage(hists).to(torch.float32)
    c = hists.shape[-1]
    return cov * (4.0 * c * c) + label_variance_normed(hists)
