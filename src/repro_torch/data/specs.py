"""Shape-and-dtype stand-ins for every model input (the dry-run's seam).

``input_specs(cfg, shape)`` returns the argument structure a step takes, as
``meta``-device tensors (nothing allocated or drawn), plus a parallel tree of
*logical* sharding axes (``repro_torch.sharding`` names), as the reference's
``repro/data/specs.py`` returns ``ShapeDtypeStruct``s.  Caches follow the
port's layout: a list a layer, no repeat axis, and a host-int ``idx``
(logical ``()``).

Modality carve-out: for the VLM and audio families the frontend is stubbed;
the specs give precomputed patch or frame embeddings of the right shape.
An encoder-decoder's decode caches are ``{"self": [...], "cross": [...]}``,
the cross K/V (B, num_frames, KV, hd) a decoder layer.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import sharding as sh
from ..configs.shapes import InputShape
from ..models import init_caches, stack_cache_specs
from ..models.config import ModelConfig

META = torch.device("meta")


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens such that patches + text == ``seq_len``."""
    if cfg.arch_type == "vlm":
        return seq_len - cfg.num_patch_tokens
    return seq_len


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: InputShape
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """Specs of a train or prefill batch: int32 ``tokens`` (and, to train,
    ``targets``) (B, S), the VLM's float32 ``patch_embeds`` and the audio
    family's float32 ``frames``."""
    b, s = shape.global_batch, text_len(cfg, shape.seq_len)
    specs = {"tokens": _spec((b, s), torch.int32)}
    logical: Dict[str, tuple] = {"tokens": (sh.BATCH, sh.SEQ)}
    if shape.kind == "train":
        specs["targets"] = _spec((b, s), torch.int32)
        logical["targets"] = (sh.BATCH, sh.SEQ)
    if cfg.arch_type == "vlm":
        specs["patch_embeds"] = _spec(
            (b, cfg.num_patch_tokens, cfg.vision_embed_dim), torch.float32)
        logical["patch_embeds"] = (sh.BATCH, None, None)
    if cfg.is_encoder_decoder:
        specs["frames"] = _spec((b, cfg.num_frames, cfg.d_model),
                                torch.float32)
        logical["frames"] = (sh.BATCH, None, None)
    return specs, logical


def decode_specs(cfg: ModelConfig, shape: InputShape
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Specs of one decode step: a token a sequence and the resident caches
    of ``shape.seq_len`` (a window's ring where ``cfg.sliding_window`` is
    shorter).  Each cache's ``idx`` is ``seq_len - 1``: the step's token is
    the last the cache holds, and it attends to a full cache.  An
    encoder-decoder's cross caches have logical axes ``(BATCH, None,
    KV_HEADS, None)``, as the reference gives them."""
    b = shape.global_batch
    caches = init_caches(cfg, b, shape.seq_len, device=META)
    cache_logical: Any = stack_cache_specs(cfg)
    for cache in (caches["self"] if cfg.is_encoder_decoder else caches):
        cache["idx"] = shape.seq_len - 1
    if cfg.is_encoder_decoder:
        cross = (sh.BATCH, None, sh.KV_HEADS, None)
        cache_logical = {"self": cache_logical,
                         "cross": [{"k": cross, "v": cross}
                                   for _ in range(cfg.num_layers)]}
    specs = {"tokens": _spec((b,), torch.int32), "caches": caches}
    logical = {"tokens": (sh.BATCH,), "caches": cache_logical}
    return specs, logical


def input_specs(cfg: ModelConfig, shape: InputShape):
    """:func:`decode_specs` for a decode shape, else :func:`batch_specs`."""
    if shape.kind == "decode":
        return decode_specs(cfg, shape)
    return batch_specs(cfg, shape)


__all__ = ["batch_specs", "decode_specs", "input_specs", "text_len"]
