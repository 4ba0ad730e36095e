"""Configurations: the paper's CNN and FL constants, and the architecture
registry (``get_config(arch_id)``) for the archs the port serves.

The reference registers ten archs.  This port serves the eight decoder-only
ones: the dense (``qwen3-14b``, ``minitron-4b``, ``qwen2-72b``,
``nemotron-4-340b``), MoE (``granite-moe-1b-a400m``, ``arctic-480b``), SSM
(``mamba2-1.3b``) and hybrid (``jamba-v0.1-52b``) families.  Asking for the
VLM or the audio arch raises a ``KeyError`` that says which later slice
brings it.
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
    "minitron-4b": "minitron_4b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-72b": "qwen2_72b",
    "nemotron-4-340b": "nemotron_4_340b",
    "arctic-480b": "arctic_480b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}
# Reference archs not served yet -> the later slice of the port that brings
# them (ROADMAP.md Queue 1).
_LATER = {
    "phi-3-vision-4.2b": "the VLM and audio slice",
    "whisper-tiny": "the VLM and audio slice",
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
