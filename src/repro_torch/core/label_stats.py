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


def expected_coverage_per_round(hists: torch.Tensor) -> torch.Tensor:
    """Union label coverage of a set of clients, n(∪_i ℒ_i) (paper §III-B:
    trainability tracks the union coverage of a round), over the clients'
    axis -2."""
    return (hists > 0).any(-2).sum(-1).to(torch.int32)


def empirical_pdf(hist: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """p(L_i): normalized histogram with ε-smoothing (KL needs full support)."""
    hist = hist.to(torch.float32) + eps
    return hist / class_sum(hist)[..., None]


# Block-reducible statistics: a merge of the values over any disjoint block
# partition equals the value over all clients.  Counts are integers in
# float32, so the sums are exact, in any order and any grouping of blocks,
# while the totals stay below 2^24.

def partial_label_statistics(hists: torch.Tensor) -> dict:
    """One block's (B, C) histograms -> ``hist_sum`` (C,) float32, the
    class counts summed over clients; ``n_valid`` float32, the clients with
    a non-empty histogram; ``present`` (C,) bool, the union of the classes
    present (its sum is §III-B's n(∪ℒ))."""
    hists = hists.to(torch.float32)
    return {"hist_sum": hists.sum(-2),
            "n_valid": (hists.sum(-1) > 0).sum(-1).to(torch.float32),
            "present": (hists > 0).any(-2)}


def merge_label_statistics(a: dict, b: dict) -> dict:
    """Merge two :func:`partial_label_statistics` dicts: sum, sum, union."""
    return {"hist_sum": a["hist_sum"] + b["hist_sum"],
            "n_valid": a["n_valid"] + b["n_valid"],
            "present": a["present"] | b["present"]}
