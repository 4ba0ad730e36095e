"""Label-wise clustering topology (paper §IV-A/B) and the clustered-FL
k-means over label histograms.

Clusters are label-membership sets C_k = {clients i : class k ∈ ℒ_i}; their
intersection pattern partitions clients into areas A_p, whose index counts
down with coverage (A_1 = clients holding every label in play).  §IV-B bounds
the number of areas by F(τ) = τ² − τ + 1.

:func:`kmeans_cluster` is the clustered families' client assignment: a
fixed number of Lloyd iterations over ε-normalized histograms, seeded
deterministically from the §IV-A priority order.  Every function takes
leading axes (the grid engine's trials), each computed as if alone.

The reference's assignments and centroids are compared bit for bit, so its
compiled CPU rounding is copied: squared distances are left-to-right fused
multiply-add chains over the classes (``ordered.class_dot``), the seed ranks
come from ``linspace`` as XLA folds it, and the centroid update sums member
pdfs in the order XLA's CPU dot takes (:func:`_member_sum`).  The sums are
written as elementwise tensor ops in that fixed order, never as a library
matmul, so a CUDA device gives the CPU's bits.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .label_stats import coverage, empirical_pdf, label_variance_normed
from .ordered import class_dot, class_sum


def cluster_membership(hists: torch.Tensor) -> torch.Tensor:
    """(…, N, C) bool: membership[i, k] ⇔ client i ∈ C_k (holds class k)."""
    return hists > 0


def cluster_sizes(hists: torch.Tensor) -> torch.Tensor:
    """n(C_k) for every label cluster k."""
    return cluster_membership(hists).sum(-2).to(torch.int32)


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


def area_counts(hists: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Histogram of clients per area index p ∈ {0..C+1} (index 0 unused)."""
    p = torch.clamp(area_index(hists, None), 0, num_classes + 1).long()
    out = torch.zeros(p.shape[:-1] + (num_classes + 2,), dtype=torch.int32,
                      device=hists.device)
    return out.scatter_add_(-1, p, torch.ones_like(p, dtype=torch.int32))


def num_areas_upper_bound(tau) -> torch.Tensor:
    """Paper Eq. (4): sup n(A^(T)) = F(τ) = τ² − τ + 1."""
    tau = torch.as_tensor(tau)
    return 1 + tau * (tau - 1)


def selection_priority(hists: torch.Tensor) -> torch.Tensor:
    """Total-order key for A_1 > A_2 > … with the Eq. (3) tie-break: coverage
    scaled past any σ²/n term (σ² of C rank values is below C²)."""
    cov = coverage(hists).to(torch.float32)
    c = hists.shape[-1]
    return cov * (4.0 * c * c) + label_variance_normed(hists)


def greedy_area_selection(hists: torch.Tensor, n_select: int) -> torch.Tensor:
    """s_T of Eq. (3): the ``n_select`` clients of highest area priority, in
    order (a stable sort, so ties go to the lower client id)."""
    order = torch.argsort(-selection_priority(hists), dim=-1, stable=True)
    return order[..., :n_select].to(torch.int32)


def seed_positions(n: int, n_clusters: int) -> List[int]:
    """Ranks of the priority order that seed the centroids:
    ``round(linspace(0, n − 1, M))`` as the reference's compiled code
    computes it in float32 (rank i is ``i · ((n − 1) · (1 / (M − 1)))``, the
    last rank n − 1, halves rounded to even)."""
    if n_clusters == 1:
        return [0]
    f32 = np.float32
    step = f32(f32(n - 1) * f32(f32(1) / f32(n_clusters - 1)))
    ranks = (np.arange(n_clusters - 1, dtype=f32) * step).astype(f32)
    return [int(r) for r in np.round(ranks)] + [n - 1]


# Client counts at which the reference's CPU dot (XLA, measured with jax
# 0.9.0 on x86-64) sums its contraction axis left to right; at every other
# count of 4 or more it keeps four strided partial sums (see _member_sum).
_SEQUENTIAL_DOT = frozenset({5, 6, 9, 10, 13, 17})


def _member_sum(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Σ_i w[…, m, i] · p[…, i, :] for 0/1 ``w`` (…, M, N) and ``p``
    (…, N, C) -> (…, M, C), in the order of the reference's ``w @ p``.

    The products are exact (w is 0 or 1), so only the order of the sums
    matters.  With M = 1, fewer than 4 clients or a count in
    ``_SEQUENTIAL_DOT`` the sum runs left to right.  Otherwise lane l sums
    clients l, l + 4, l + 8, … of the first 4·⌊N/4⌋ left to right, the lanes
    join as (l0 + l1) + (l2 + l3), and a tail of r = N mod 4 clients is
    added last as x, (x + y) or ((x + y) + z)."""
    prod = w[..., :, :, None] * p[..., None, :, :]       # (…, M, N, C)
    n = prod.shape[-2]
    if w.shape[-2] == 1 or n < 4 or n in _SEQUENTIAL_DOT:
        acc = prod[..., 0, :]
        for i in range(1, n):
            acc = acc + prod[..., i, :]
        return acc
    main = n - n % 4
    lanes = prod[..., :main, :].reshape(prod.shape[:-2] + (main // 4, 4,
                                                          prod.shape[-1]))
    acc = lanes[..., 0, :, :]
    for r in range(1, main // 4):
        acc = acc + lanes[..., r, :, :]
    total = ((acc[..., 0, :] + acc[..., 1, :])
             + (acc[..., 2, :] + acc[..., 3, :]))
    tail = [prod[..., i, :] for i in range(main, n)]
    if tail:
        t = tail[0]
        for x in tail[1:]:
            t = t + x
        total = total + t
    return total


def _nearest(p: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(…, N) index of each point's nearest centroid; ties go to the lower
    cluster.  Squared distances are class-axis FMA chains, as the
    reference's CPU code sums ``((p − c) ** 2).sum(-1)``."""
    d = p[..., :, None, :] - cent[..., None, :, :]        # (…, N, M, C)
    d2 = class_dot(d, d)                                  # (…, N, M)
    best, arg = d2[..., 0], torch.zeros(d2.shape[:-1], dtype=torch.int32,
                                         device=d2.device)
    for m in range(1, d2.shape[-1]):
        closer = d2[..., m] < best
        best = torch.where(closer, d2[..., m], best)
        arg = torch.where(closer, m, arg)
    return arg


def kmeans_cluster(hists: torch.Tensor, n_clusters: int, *,
                   n_iters: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration Lloyd k-means over normalized label histograms:
    (…, N, C) hists -> ((…, N) int32 assignment, (…, M, C) centroids).

    Points are ε-normalized pdfs (``empirical_pdf``), so clients cluster by
    label distribution.  Centroid m seeds from the client at rank
    ``seed_positions(N, M)[m]`` of the descending :func:`selection_priority`
    order (a stable sort).  An empty (dark) client still gets an assignment
    but enters no centroid update, and a cluster with no valid member keeps
    its centroid.  Deterministic and key-free, so every engine agrees on it."""
    if n_clusters < 1:
        raise ValueError(f"n_clusters must be >= 1; got {n_clusters}")
    p = empirical_pdf(hists)                                   # (…, N, C)
    valid = (class_sum(hists) > 0).to(torch.float32)           # (…, N)
    order = torch.argsort(-selection_priority(hists), dim=-1, stable=True)
    n = hists.shape[-2]
    seeds = order[..., seed_positions(n, n_clusters)]          # (…, M)
    cent = torch.gather(p, -2, seeds[..., None].expand(
        seeds.shape + (p.shape[-1],)))
    ids = torch.arange(n_clusters, device=hists.device)[:, None]
    for _ in range(n_iters):
        member = (_nearest(p, cent)[..., None, :] == ids)      # (…, M, N)
        w = member.to(torch.float32) * valid[..., None, :]
        tot = w.sum(-1, keepdim=True)                          # exact counts
        cent = torch.where(tot > 0,
                           _member_sum(w, p) / torch.clamp(tot, min=1.0),
                           cent)
    return _nearest(p, cent), cent


def cluster_counts(assign: torch.Tensor, n_clusters: int,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(…, M) float32 population of each cluster, optionally weighted (pass
    the validity mask to count valid clients only): the engines' weights for
    mixing per-cluster eval results into one number."""
    ids = torch.arange(n_clusters, device=assign.device)[:, None]
    w = (assign[..., None, :] == ids).to(torch.float32)
    if weights is not None:
        w = w * weights.to(torch.float32)[..., None, :]
    return w.sum(-1)
