"""Learning-rate schedules: functions of the step counter that return a
float32 0-dim tensor, with the reference's arithmetic
(``repro.optim.schedules``).

Each float32 operation of the reference is taken here in float64 and
rounded once to float32.  For a sum, product or quotient of float32 values
that is the correctly rounded float32 result (float64 carries more than
twice float32's bits), which is what the reference's operations give one at
a time; PyTorch's own float32 division by a scalar multiplies by the
reciprocal and may round twice.  The cosine is the reference's own
(``core.ordered.cos``): near the schedule's end ``1 + cos`` cancels, and a
cosine one ulp off moves the rate by many ulps.
"""
from __future__ import annotations

import math

import torch

from ..core.ordered import cos as _cos32

_F32, _F64 = torch.float32, torch.float64


def _f32(x) -> torch.Tensor:
    """``x`` rounded to float32, carried in float64 for the next op."""
    return torch.as_tensor(x, dtype=_F64).to(_F32).to(_F64)


def _step(step) -> torch.Tensor:
    """The step counter (a Python int or an integer tensor) as float32."""
    return torch.as_tensor(step).to(_F32).to(_F64)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def _cosine64(lr: float, total_steps: int, final_frac: float):
    pi, lr32 = _f32(math.pi), _f32(lr)
    ff, keep = _f32(final_frac), _f32(1 - final_frac)

    def f(step) -> torch.Tensor:
        t = torch.clamp(_f32(_step(step) / max(total_steps, 1)), 0.0, 1.0)
        c = _f32(0.5 * _f32(1 + _cos32(_f32(pi * t)).to(_F64)))
        return _f32(lr32 * _f32(ff + _f32(keep * c)))
    return f


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    f = _cosine64(lr, total_steps, final_frac)
    return lambda step: f(step).to(_F32)


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = _cosine64(lr, max(total_steps - warmup_steps, 1), final_frac)
    lr32 = _f32(lr)

    def f(step) -> torch.Tensor:
        s = _step(step)
        warm = _f32(_f32(lr32 * s) / max(warmup_steps, 1))
        return torch.where(s < warmup_steps, warm,
                           cos(torch.as_tensor(step) - warmup_steps)).to(_F32)
    return f


def get_schedule(name: str, lr: float, **kw):
    if name == "constant":
        return constant(lr)
    if name == "cosine":
        return cosine(lr, **kw)
    if name == "warmup_cosine":
        return warmup_cosine(lr, **kw)
    raise KeyError(f"unknown schedule {name!r}")
