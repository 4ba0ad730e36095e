"""Seeded ``torch.Generator``s derived from a path of integers.

The round loop derives one generator per use (init, a round's data, a
round's selection) from ``(seed, ...)``, the way the reference folds JAX keys.
The draws differ from the reference's; tests feed both stacks the same
numpy-made inputs instead.
"""
from __future__ import annotations

import numpy as np
import torch


def generator(device: "str | torch.device", *path: int) -> torch.Generator:
    """A generator on ``device`` seeded from the non-negative ints ``path``."""
    seed = int(np.random.SeedSequence([int(p) for p in path])
               .generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)
