"""The paper's local-client model (§III-B): Conv2D–Pool–Conv2D–Pool–Flatten–
Dense–Dense, sized for 28×28×1 images.

Layout: images are NHWC at the public functions, as in the reference.  Conv
weights are stored OIHW (PyTorch's), dense weights (in, out) as in the
reference.  Inside, activations run NCHW for ``F.conv2d``/``F.max_pool2d`` and
are permuted back to NHWC before the flatten, so ``fc1.w``'s rows keep the
reference's (H, W, C) order.  Parameters are a flat ``dict[str, Tensor]``
(``conv1.w``, ``conv1.b``, …, ``fc2.b``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import rng
from ..device import resolve_device

Params = Dict[str, torch.Tensor]

# Leaves whose layout differs from the reference's, with the axis order that
# takes the reference's array to the port's (HWIO -> OIHW); every other leaf
# has the same layout in both.  ``repro_torch.convert`` reads this.
REFERENCE_LAYOUT = {"conv1.w": (3, 2, 0, 1), "conv2.w": (3, 2, 0, 1)}


def cnn_init(key: "rng.KeyLike | None" = None,
             num_classes: int = 10, image_size: int = 28, channels: int = 1,
             c1: int = 32, c2: int = 64, hidden: int = 128,
             device: "str | torch.device | None" = None) -> Params:
    """He-normal weights and zero biases from ``key`` (``PRNGKey(0)`` when
    None), as the reference draws them: ``split(key, 4)``, one leaf each,
    conv weights drawn in the reference's HWIO layout and stored OIHW.  A
    batch of keys (…, 2) gives a batch of models, leaves (…, *shape)."""
    device = resolve_device(device)
    key = rng.as_key(rng.PRNGKey(0) if key is None else key, device)
    lead = key.shape[:-1]
    ks = rng.split(key, 4)
    s = image_size // 4  # two 2× pools
    flat = s * s * c2

    def he(i, shape, fan_in, perm=None):
        scale = float(torch.tensor(math.sqrt(2.0 / fan_in),
                                   dtype=torch.float32))
        w = rng.normal(ks[..., i, :], shape) * scale
        if perm is None:
            return w
        return w.permute(tuple(range(len(lead)))
                         + tuple(len(lead) + a for a in perm)).contiguous()

    def zeros(n):
        return torch.zeros(lead + (n,), device=device)

    hwio = REFERENCE_LAYOUT["conv1.w"]
    return {
        "conv1.w": he(0, (3, 3, channels, c1), 9 * channels, hwio),
        "conv1.b": zeros(c1),
        "conv2.w": he(1, (3, 3, c1, c2), 9 * c1, hwio),
        "conv2.b": zeros(c2),
        "fc1.w": he(2, (flat, hidden), flat), "fc1.b": zeros(hidden),
        "fc2.w": he(3, (hidden, num_classes), hidden),
        "fc2.b": zeros(num_classes),
    }


def cnn_apply(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, params["conv1.w"], params["conv1.b"], padding=1))
    x = F.max_pool2d(x, 2)
    x = F.relu(F.conv2d(x, params["conv2.w"], params["conv2.b"], padding=1))
    x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1.w"] + params["fc1.b"])
    return x @ params["fc2.w"] + params["fc2.b"]


def cnn_loss(params: Params, images: torch.Tensor, labels: torch.Tensor,
             valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Categorical cross-entropy with a padding mask; returns (loss,
    {"accuracy", "n"}).  Padded rows (−1 labels, valid False) contribute 0."""
    logits = cnn_apply(params, images).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    # −1 padding indexes the last class, as the reference's gather does; the
    # valid mask zeroes those rows.
    idx = torch.where(labels < 0, labels + logits.shape[-1], labels)
    gold = torch.gather(logits, -1, idx[:, None])[:, 0]
    nll = logz - gold
    valid = (torch.ones_like(nll) if valid is None
             else valid.to(torch.float32))
    denom = torch.clamp(valid.sum(), min=1.0)
    loss = (nll * valid).sum() / denom
    acc = ((torch.argmax(logits, -1) == labels) * valid).sum() / denom
    return loss, {"accuracy": acc, "n": denom}
