"""The FL round's two heavy non-training ops, in front of their kernels.

Per-client label histograms (what every selection strategy ranks on) and the
masked weighted mean of client models (FedAvg Eq. 1) go through the
hand-written CUDA kernels when their tensors lie on a CUDA device, and
through the kernels' plain versions when they lie on the CPU: the device of
the tensors decides, nothing else does.  ``backend="reference"`` instead
computes the reference's own formulas (``core.label_stats.histogram``,
``core.aggregation.masked_mean``) on any device, which is what the kernels
are compared with.  ``backend="auto"`` (the default) reads the
``REPRO_COMPUTE_BACKEND`` environment variable at each call, as the
reference does: unset, empty or ``auto`` takes the device's path,
``reference`` sends every dispatch on CPU tensors to the reference formulas
and raises on CUDA tensors (nothing on the card falls back to a plain
version unasked; the explicit ``backend="reference"`` keyword is the way to
compare there), and any other value raises (the reference's ``pallas`` and
``pallas_interpret`` name TPU kernels the port does not have).

Numerics:

* ``client_histograms``: kernel, plain version and reference are bit-equal
  (sums of 0/1 weights, exact in float32).
* ``masked_weighted_mean`` / ``weighted_sum_tree``: float32 ulp level; the
  kernel accumulates in float32 in its own order.  ``weighted_sum_tree`` keeps
  each leaf's dtype on both paths.  Both take an optional leading trial axis
  (leaves (T, K, …) with weights (T, K) -> (T, …)), the grid engine's
  independent FL runs, in the same one launch; each trial's result is
  bit-equal to its own one-trial call.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from ..core.aggregation import masked_mean
from ..core.label_stats import histogram, label_variance_normed
from .label_hist.label_hist import label_hist_kernel
from .weighted_agg.weighted_agg import weighted_agg_leaves

Params = Dict[str, torch.Tensor]
BACKENDS = ("auto", "reference")
ENV_VAR = "REPRO_COMPUTE_BACKEND"
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def compute_backend(backend: str = "auto") -> str:
    """``backend`` resolved as a dispatch call resolves it: ``auto`` becomes
    ``ENV_VAR``'s value when that is set and not empty.  Returns ``auto``
    (each call's tensors decide: the kernel on a CUDA device, its plain
    version on the CPU) or ``reference``; raises on any other value (the
    reference's ``pallas`` and ``pallas_interpret`` name TPU kernels)."""
    if backend not in BACKENDS:
        raise ValueError(f"compute backend must be one of {BACKENDS}; "
                         f"got {backend!r}")
    if backend == "auto":
        backend = os.environ.get(ENV_VAR, "") or "auto"
        if backend not in BACKENDS:
            raise ValueError(f"{ENV_VAR} must be one of {BACKENDS} or unset; "
                             f"got {backend!r}")
    return backend


def _check(backend: str, device: torch.device) -> str:
    """``backend`` resolved for tensors on ``device``
    (:func:`compute_backend`); the environment may ask for ``reference``
    only off the card."""
    resolved = compute_backend(backend)
    if backend == "auto" and resolved == "reference" \
            and device.type == "cuda":
        raise RuntimeError(
            f"{ENV_VAR}=reference would send CUDA tensors past their "
            f"kernels; unset it, or pass backend='reference' to compare")
    return resolved


def client_histograms(labels: torch.Tensor, num_classes: int,
                      valid: Optional[torch.Tensor] = None, *,
                      backend: str = "auto") -> torch.Tensor:
    """(…, n) integer labels -> (…, C) float32 counts.  Out-of-range labels
    (-1 padding) count toward no bin; ``valid`` masks entries on top."""
    if _check(backend, labels.device) == "reference":
        return histogram(labels, num_classes, valid)
    labels = labels.to(torch.int32)
    n = labels.shape[-1]
    v = (labels >= 0) if valid is None else valid.to(torch.bool)
    v = torch.broadcast_to(v, labels.shape)
    out = label_hist_kernel(labels.reshape(-1, n).contiguous(),
                            v.reshape(-1, n).contiguous(), num_classes)
    return out.reshape(labels.shape[:-1] + (num_classes,))


def client_statistics(labels: torch.Tensor, num_classes: int,
                      valid: Optional[torch.Tensor] = None, *,
                      backend: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Histogram and the Algorithm-1 score: -> (hists (…, C), σ²/n (…,))."""
    hists = client_histograms(labels, num_classes, valid, backend=backend)
    return hists, label_variance_normed(hists)


def _leaf_sums(tree: Params, w: torch.Tensor,
               denom: Optional[torch.Tensor] = None) -> Params:
    """Σ_k w_k · leaf_k over every leaf's client axis (÷ denom when given),
    one kernel launch for all leaves of one dtype.  ``w`` (K,) or, with a
    trial axis, (T, K): the leaves' leading axes are ``w``'s.  The kernel
    reads float32 and bfloat16; a leaf of another floating dtype (float16,
    float64) is summed in float32 and its result cast back to its dtype."""
    lead = w.dim()
    flats = [x.reshape(x.shape[:lead] + (-1,)).contiguous()
             for x in tree.values()]
    flats = [x if x.dtype in _KERNEL_DTYPES else x.to(torch.float32)
             for x in flats]
    sums = weighted_agg_leaves(flats, w, denom)
    return {k: y.reshape(x.shape[:lead - 1] + x.shape[lead:]).to(x.dtype)
            for (k, x), y in zip(tree.items(), sums)}


def _per_trial(fn, tree: Params, *vectors: Optional[torch.Tensor]) -> Params:
    """``fn`` on each trial of a (T, K, …) tree with (T, K) vectors, stacked
    back to (T, …): the reference formulas have no trial axis."""
    trials = [fn({k: x[t] for k, x in tree.items()},
                 *(None if v is None else v[t] for v in vectors))
              for t in range(vectors[0].shape[0])]
    return {k: torch.stack([r[k] for r in trials]) for k in tree}


def masked_weighted_mean(stacked: Params, mask: torch.Tensor,
                         weights: Optional[torch.Tensor] = None, *,
                         backend: str = "auto") -> Params:
    """Weighted mean over the client axis restricted to ``mask``: the
    FedAvg/FedSGD server reduction, with ``masked_mean``'s signature and its
    ε-denominator for an empty mask.  ``mask`` (K,), or (T, K) for leaves
    (T, K, …) -> (T, …) with a denominator a trial.  The kernel path sums
    each leaf in float32 and divides by Σw in float32 before rounding to the
    leaf's dtype, as the reference's kernel path does, in one launch for the
    whole tree and every trial."""
    if _check(backend, mask.device) == "reference":
        if mask.dim() == 2:
            return _per_trial(masked_mean, stacked, mask, weights)
        return masked_mean(stacked, mask, weights)
    w = mask.to(torch.float32)
    if weights is not None:
        w = w * weights.to(torch.float32)
    return _leaf_sums(stacked, w, torch.clamp(w.sum(-1), min=1e-12))


def weighted_sum_tree(tree: Params, weights: torch.Tensor, *,
                      backend: str = "auto") -> Params:
    """Σ_k w_k · x_k over every leaf's client axis, without normalizing;
    ``weights`` (K,), or (T, K) for leaves (T, K, …) -> (T, …).  Every leaf
    keeps its dtype: the reference reduces in the leaf's dtype, the kernel
    accumulates in float32 and rounds once."""
    w = weights.to(torch.float32)
    if _check(backend, w.device) == "reference":
        if w.dim() == 2:
            return _per_trial(
                lambda t, v: weighted_sum_tree(t, v, backend="reference"),
                tree, w)
        return {k: (w.reshape(w.shape + (1,) * (x.dim() - 1)).to(x.dtype)
                    * x).sum(0) for k, x in tree.items()}
    return _leaf_sums(tree, w)
