"""Configurations: the paper's CNN and FL constants, and the architecture
registry (``get_config(arch_id)``) for the archs the port serves.

The port serves the reference's ten archs: the dense (``qwen3-14b``,
``minitron-4b``, ``qwen2-72b``, ``nemotron-4-340b``), MoE
(``granite-moe-1b-a400m``, ``arctic-480b``), SSM (``mamba2-1.3b``), hybrid
(``jamba-v0.1-52b``), VLM (``phi-3-vision-4.2b``) and audio encoder-decoder
(``whisper-tiny``) families.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

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
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "whisper-tiny": "whisper_tiny",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"{__name__}.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "CONFIG", "FL", "FLConfig", "InputShape",
           "ModelConfig", "PaperCNNConfig", "SHAPES", "all_configs",
           "get_config"]
