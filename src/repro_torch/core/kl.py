"""Training-free client evaluation via KL divergence (paper §IV-C, Eq. 5).

``forward`` is D_KL(p(L_i) ‖ U) = log C − H(p), which the ``kl`` selection
strategy minimizes; ``reverse`` is the paper's Eq. (5) orientation.
"""
from __future__ import annotations

import torch

from .label_stats import empirical_pdf
from .ordered import class_dot, class_sum, log


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """D_KL(p ‖ q) = Σ p log(p/q), elementwise-safe (0·log 0 := 0)."""
    terms = p * (log(torch.clamp(p, min=1e-30))
                 - log(torch.clamp(q, min=1e-30)))
    return class_sum(torch.where(p > 0, terms, 0.0))


def kl_to_uniform(hist: torch.Tensor, direction: str = "forward",
                  eps: float = 1e-9) -> torch.Tensor:
    """KL between a client's empirical label pdf and the uniform pdf."""
    p = empirical_pdf(hist, eps=eps)
    u = torch.full_like(p, 1.0 / hist.shape[-1])
    if direction == "forward":
        return kl_divergence(p, u)
    if direction == "reverse":
        # u > 0 everywhere, so the 0·log 0 guard is void and each term is one
        # fused multiply-add, as in the reference's compiled code.
        return class_dot(u, log(u) - log(torch.clamp(p, min=1e-30)))
    raise ValueError(f"unknown direction {direction!r}")


def uniformity_score(hist: torch.Tensor) -> torch.Tensor:
    """Higher = more uniform = better client (−KL_forward)."""
    return -kl_to_uniform(hist, direction="forward")
