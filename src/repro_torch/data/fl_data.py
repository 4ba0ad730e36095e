"""Materialize FL client rounds from non-IID label plans.

A round batch is a fixed-shape structure:
    images: (N, n_max, H, W, C)   labels: (N, n_max) int32 (−1 pad)
    valid:  (N, n_max) bool       hists:  (N, C) float32
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..kernels.dispatch import client_histograms
from .synthetic import ImageDataset, TokenDataset


def round_histograms(ds: "ImageDataset | TokenDataset",
                     plan_t: "np.ndarray | torch.Tensor"
                     ) -> Dict[str, torch.Tensor]:
    """plan_t (…, N, n_max) int32 labels with −1 padding -> ``labels``,
    ``valid`` and ``hists`` (…, N, C) on the dataset's device (C its
    ``num_classes``), without the payload: every row of every leading index
    in one ``label_hist`` launch on a CUDA device (its plain version on the
    CPU; bit-equal counts)."""
    labels = torch.as_tensor(plan_t, dtype=torch.int32, device=ds.device)
    valid = labels >= 0
    hists = client_histograms(torch.where(valid, labels, 0), ds.num_classes,
                              valid)
    return {"labels": labels, "valid": valid, "hists": hists}


def materialize_round(ds: ImageDataset, plan_t: "np.ndarray | torch.Tensor",
                      key) -> Dict[str, torch.Tensor]:
    """plan_t (N, n_max) int32 labels with −1 padding -> round batch on the
    dataset's device, images drawn from ``key`` as the reference draws
    them.  Histograms go through the label_hist kernel on a CUDA device and
    its plain version on the CPU (bit-equal counts)."""
    data = round_histograms(ds, plan_t)
    return {"images": ds.sample(key, data["labels"]), **data}


def client_batches(data: Dict[str, torch.Tensor], batch_size: int,
                   keys: Optional[Iterable[str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """(N, n_max, ...) -> (N, n_batches, batch_size, ...), padding the tail
    with invalid rows (False for bool leaves, 0 otherwise) so every client has
    the same batch structure.  ``keys`` names the per-sample leaves to fold;
    ``None`` folds every leaf but ``"hists"``."""
    n, n_max = data["labels"].shape
    nb = -(-n_max // batch_size)
    pad = nb * batch_size - n_max
    keys = tuple(k for k in data if k != "hists") if keys is None else keys

    def prep(x: torch.Tensor) -> torch.Tensor:
        if pad:
            fill = torch.zeros((n, pad) + x.shape[2:], dtype=x.dtype,
                               device=x.device)
            x = torch.cat([x, fill], dim=1)
        return x.reshape((n, nb, batch_size) + x.shape[2:])

    return {k: prep(data[k]) for k in keys}
