"""Per-client label statistics (paper §III/§IV), on (…, C) label histograms.

Classes are independent semantic entities: before a statistic is computed,
the labels present in a client's multiset are remapped to sequential ranks
(``{1, 5, 10} ≡ {0, 1, 2}``, §III-A).

Sums over the class axis round as the reference's compiled CPU code does
(``core.ordered``), so scores agree with it to the bit and selection orders
cannot flip on a last-bit difference.
"""
from __future__ import annotations

import torch

from .ordered import class_dot, class_sum


def histogram(labels: torch.Tensor, num_classes: int,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """(…, n) integer labels -> (…, C) float32 counts (the plain version).

    ``valid`` optionally weights entries (padding masks); out-of-range labels
    (-1 padding) match no class.  One comparison pass per class, so the
    (…, n, C) one-hot never exists."""
    labels = labels.to(torch.int32)
    weights = (torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
               if valid is None else valid.to(torch.float32))
    out = torch.empty(labels.shape[:-1] + (num_classes,), dtype=torch.float32,
                      device=labels.device)
    for c in range(num_classes):
        out[..., c] = torch.where(labels == c, weights, 0.0).sum(-1)
    return out


def rank_remap_values(hist: torch.Tensor) -> torch.Tensor:
    """Sequential rank of each present class (absent classes get rank 0)."""
    present = (hist > 0).to(torch.float32)
    ranks = torch.cumsum(present, dim=-1) - 1.0
    return ranks * present


def _variance_parts(hist: torch.Tensor):
    """(Σ_c h_c (v_c − mean)², n) of the rank-remapped multiset."""
    hist = hist.to(torch.float32)
    n = torch.clamp(class_sum(hist), min=1.0)
    v = rank_remap_values(hist)
    mean = class_dot(hist, v) / n
    return class_dot(hist, (v - mean[..., None]) ** 2), n


def label_variance(hist: torch.Tensor) -> torch.Tensor:
    """σ²(L_i) of the rank-remapped label multiset (the selection statistic).
    A single-label client has σ² = 0."""
    ss, n = _variance_parts(hist)
    return ss / n


def label_variance_normed(hist: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (3) score: σ²(L_i) / n_i, divided once by n², as the
    reference's compiled code rewrites its (σ²·n / n) / n."""
    ss, n = _variance_parts(hist)
    return ss / (n * n)


def coverage(hist: torch.Tensor) -> torch.Tensor:
    """Number of distinct labels present, n(ℒ_i)."""
    return (hist > 0).sum(-1).to(torch.int32)


def empirical_pdf(hist: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """p(L_i): normalized histogram with ε-smoothing (KL needs full support)."""
    hist = hist.to(torch.float32) + eps
    return hist / class_sum(hist)[..., None]
