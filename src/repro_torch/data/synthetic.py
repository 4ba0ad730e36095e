"""Synthetic class-conditional data (offline stand-ins for MNIST/FMNIST and
for LM token streams).

Images: class k is a fixed random smooth template T_k plus Gaussian noise.
The templates come from NumPy (seed 1234) and are bit-equal to the
reference's; the noise is ``repro_torch.rng.normal`` under the caller's key,
the reference's draw (to the ulp level ``rng`` states).  Each element's noise
depends only on the key and its flat index, so :meth:`ImageDataset.sample`
can draw a subset of rows and get exactly those rows of the whole draw.

Tokens: domain k is a skewed unigram distribution over a vocab band.  Its
log-probabilities come from NumPy (seed 77) and are bit-equal to the
reference's; the draws are ``rng.categorical``'s under the caller's key,
bit-equal to the reference's ``jax.random.categorical``, and each row of
them, too, depends only on the key and its counter offset.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import rng
from ..device import resolve_device


def image_templates(num_classes: int, image_size: int, channels: int,
                    seed: int) -> np.ndarray:
    """(C, H, W, channels) float32 class templates: normal noise smoothed by a
    wrapped 5×5 box filter, then standardized."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(num_classes, image_size, image_size, channels))
    k = 5
    pad = k // 2
    padded = np.pad(raw, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="wrap")
    smooth = np.zeros_like(raw)
    for dy in range(k):
        for dx in range(k):
            smooth += padded[:, dy:dy + image_size, dx:dx + image_size]
    smooth /= k * k
    smooth = (smooth - smooth.mean()) / (smooth.std() + 1e-9)
    return smooth.astype(np.float32)


@dataclasses.dataclass
class ImageDataset:
    """Class-conditional image sampler; images are NHWC, as in the reference."""
    num_classes: int = 10
    image_size: int = 28
    channels: int = 1
    noise: float = 0.35
    seed: int = 1234
    device: "str | torch.device | None" = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.templates = torch.from_numpy(image_templates(
            self.num_classes, self.image_size, self.channels,
            self.seed)).to(self.device)

    def sample(self, key: "rng.KeyLike", labels: torch.Tensor,
               rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """labels (…, R, n) int -> images (…, R, n, H, W, C), label −1 ->
        zeros, with the reference's noise ``normal(key, images.shape)``.

        ``key`` is one key (2,) or one per leading index (…, 2).  With
        ``rows`` (…, S) int, only those rows of the last-but-one axis are
        drawn -> (…, S, n, H, W, C): each row's noise comes from its own
        counter offset, so the result is bit-equal to ``sample(key,
        labels)`` gathered at ``rows``."""
        labels = torch.as_tensor(labels, dtype=torch.int32, device=self.device)
        key = rng.as_key(key, self.device)
        if labels.dim() == 1:       # (n,) samples: one row
            return self.sample(key, labels[None], rows)[0]
        per_row = labels.shape[-1] * self.image_size ** 2 * self.channels
        if rows is None:
            rows = torch.arange(labels.shape[-2], device=self.device)
            rows = rows.expand(labels.shape[:-1])
        rows = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        labels = torch.gather(labels, -2, rows[..., None].expand(
            rows.shape + labels.shape[-1:]))
        keys = key.expand(labels.shape[:-2] + (2,))
        noise = rng.normal_rows(keys[..., None, :].expand(rows.shape + (2,)),
                                rows * per_row, per_row)
        noise = noise.reshape(labels.shape + self.templates.shape[1:])
        base = self.templates[torch.clamp(labels, min=0)]
        return (base + noise * self._noise32) * (labels >= 0)[..., None, None,
                                                              None]

    @property
    def _noise32(self) -> float:
        return float(torch.tensor(self.noise, dtype=torch.float32))

    def test_set(self, n_per_class: int = 50,
                 seed: int = 999) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's held-out set: every class ``n_per_class`` times,
        noise from ``PRNGKey(seed)``."""
        labels = torch.arange(self.num_classes, dtype=torch.int32,
                              device=self.device).repeat(n_per_class)
        return self.sample(rng.PRNGKey(seed), labels), labels


def token_log_probs(num_domains: int, vocab_size: int, concentration: float,
                    seed: int) -> np.ndarray:
    """(domains, vocab) float32 log-probabilities: domain k puts
    ``concentration`` of its mass on band k (Dirichlet weights) and spreads
    the rest evenly over the other tokens."""
    rng = np.random.default_rng(seed)
    band = vocab_size // num_domains
    probs = np.full((num_domains, vocab_size),
                    (1 - concentration) / (vocab_size - band))
    for k in range(num_domains):
        w = rng.dirichlet(np.ones(band)) * concentration
        probs[k, k * band:(k + 1) * band] = w
    return np.log(probs).astype(np.float32)


@dataclasses.dataclass
class TokenDataset:
    """Domain-conditional unigram token sampler for LM-style clients and
    serving prompts.  Domain k concentrates 85% of its mass on a contiguous
    vocab band."""
    num_domains: int = 10
    vocab_size: int = 512
    seq_len: int = 64
    concentration: float = 0.85
    seed: int = 77
    device: "str | torch.device | None" = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.log_probs = torch.from_numpy(token_log_probs(
            self.num_domains, self.vocab_size, self.concentration,
            self.seed)).to(self.device)

    @property
    def num_classes(self) -> int:
        """The label space an FL round counts: the domain ids."""
        return self.num_domains

    def sample(self, key: "rng.KeyLike", domains: torch.Tensor,
               rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """domains (…, n) int -> token sequences (…, n, seq_len) int64, the
        reference's ``categorical(key, log_probs[domains], shape=(…, n,
        seq_len))``; domain −1 draws from domain 0, as in the reference.

        ``key`` is one key (2,) or one per leading index (…, 2) of
        ``domains``.  With ``rows`` (…, S) int and domains (…, R, n), only
        those rows of the last-but-one axis are drawn -> (…, S, n,
        seq_len), bit-equal to the whole draw gathered at ``rows`` (each
        sequence's gumbels sit at their own counter offset)."""
        domains = torch.as_tensor(domains, dtype=torch.int64,
                                  device=self.device)
        key = rng.as_key(key, self.device)
        per_seq = self.seq_len * self.vocab_size
        if rows is not None:
            rows = torch.as_tensor(rows, dtype=torch.int64,
                                   device=self.device)
            n = domains.shape[-1]
            domains = torch.gather(domains, -2, rows[..., None].expand(
                rows.shape + (n,)))
            seq = rows[..., None] * n + torch.arange(n, device=self.device)
        else:
            own = domains.shape[key.dim() - 1:]
            seq = torch.arange(math.prod(own),
                               device=self.device).reshape(own)
        keys = key.reshape(key.shape[:-1] + (1,) * (domains.dim()
                                                    - key.dim() + 1) + (2,))
        lp = self.log_probs[torch.clamp(domains, min=0)]
        return rng.categorical_rows(keys, seq * per_seq, lp, self.seq_len)


def _normal_rows_of(key, shape, rows: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """``normal(key, shape)``, or only its ``rows`` of the leading axis,
    bit-equal to those rows of the whole draw."""
    if rows is None:
        return rng.normal(key, shape)
    per = math.prod(shape[1:])
    rows = torch.as_tensor(rows, dtype=torch.int64)
    key = rng.as_key(key)
    return rng.normal_rows(key, rows.to(key.device) * per, per).reshape(
        (rows.shape[0],) + tuple(shape[1:]))


def modality_inputs(cfg, key, batch: int,
                    rows: Optional[torch.Tensor] = None) -> dict:
    """The stub frontends' inputs under ``key``, as the reference's launchers
    draw them: a VLM's ``patch_embeds`` (B, num_patch_tokens,
    vision_embed_dim), an encoder-decoder's ``frames`` (B, num_frames,
    d_model), each ``normal(key, shape)`` in float32; nothing for the text
    archs.  ``cfg`` is a ``models.config.ModelConfig``.  With ``rows`` only
    those rows of B are drawn (a rank's share), bit-equal to the whole
    draw's."""
    out = {}
    if cfg.arch_type == "vlm":
        out["patch_embeds"] = _normal_rows_of(
            key, (batch, cfg.num_patch_tokens, cfg.vision_embed_dim), rows)
    if cfg.is_encoder_decoder:
        out["frames"] = _normal_rows_of(
            key, (batch, cfg.num_frames, cfg.d_model), rows)
    return out
