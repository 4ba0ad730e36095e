"""Configurations: the paper's CNN and FL constants, and the architecture
registry (``get_config(arch_id)``) for the archs the port serves.

The reference registers ten archs.  This port serves the dense and SSM
families, ``qwen3-14b`` and ``mamba2-1.3b``; asking for any other reference
arch raises a ``KeyError`` that says which later slice brings it.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig
from .paper_cnn import CONFIG, FL, FLConfig, PaperCNNConfig
from .shapes import SHAPES, InputShape

_ARCH_MODULES = {
    "qwen3-14b": "qwen3_14b",
    "mamba2-1.3b": "mamba2_1_3b",
}
# Reference archs not served yet -> the later slice of the port that brings
# them (ROADMAP.md Queue 1).
_LATER = {
    "phi-3-vision-4.2b": "the VLM slice",
    "nemotron-4-340b": "the slice of the remaining dense configs",
    "arctic-480b": "the MoE slice",
    "whisper-tiny": "the audio (encoder-decoder) slice",
    "minitron-4b": "the slice of the remaining dense configs",
    "granite-moe-1b-a400m": "the MoE slice",
    "qwen2-72b": "the slice of the remaining dense configs",
    "jamba-v0.1-52b": "the hybrid (attention + Mamba + MoE) slice",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _LATER:
        raise KeyError(f"arch {arch_id!r} is not ported yet: it comes with "
                       f"{_LATER[arch_id]} (a later slice of the port, "
                       f"ROADMAP.md Queue 1); have {ARCH_IDS}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"{__name__}.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "CONFIG", "FL", "FLConfig", "InputShape",
           "ModelConfig", "PaperCNNConfig", "SHAPES", "get_config"]
