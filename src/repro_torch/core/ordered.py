"""Float32 arithmetic with the reference's rounding, for the selection scores.

Selection orders are compared bit for bit with the reference, so two clients
whose scores differ in the last bit must differ the same way in both stacks.
The reference's scores come out of compiled CPU code that (1) sums the class
axis left to right, (2) fuses a product that feeds such a sum into one
fused multiply-add, and (3) takes ``log`` with a Cephes polynomial rather than
the correctly rounded one.  These helpers reproduce all three, identically on
the CPU and on a CUDA device: a fused multiply-add is taken in float64, where
the product of two float32 values is exact, and rounded once to float32.
"""
from __future__ import annotations

import torch

_F64 = torch.float64


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (Python numbers are float32
    constants).  The float64 sum can round twice
    only when the exact result sits on a float32 tie after the first
    rounding, which float32 inputs almost never reach."""
    dev = next(x for x in (a, b, c) if isinstance(x, torch.Tensor)).device
    a64, b64, c64 = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                     .to(_F64) for x in (a, b, c))
    return (a64 * b64 + c64).to(torch.float32)


def class_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    acc = x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c]
    return acc


def class_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_c a_c · b_c over the last axis as a chain of fused multiply-adds,
    left to right from 0."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1],
                      dtype=torch.float32, device=a.device)
    for c in range(a.shape[-1]):
        acc = fma(a[..., c], b[..., c], acc)
    return acc


# Cephes logf: log(1 + x) ≈ x − x²/2 + x³·P(x) on [√½ − 1, √2 − 1].
_P = [7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
      1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
      3.3333331174e-1]
_LN2_LO, _LN2_HI = -2.12194440e-4, 0.693359375


def log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 values (the callers clamp to
    ≥ 1e-30), with the reference's CPU polynomial and its FMA placement."""
    m, e = torch.frexp(x)                      # x = m · 2^e, m ∈ [0.5, 1)
    e = e.to(torch.float32)
    small = m < 0.707106781186547524
    e = e - small.to(torch.float32)
    xm = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = xm * xm
    x3 = x2 * xm
    y = fma(_P[0], xm, _P[1])
    y1 = fma(_P[3], xm, _P[4])
    y2 = fma(_P[6], xm, _P[7])
    y = fma(y, xm, _P[2])
    y1 = fma(y1, xm, _P[5])
    y2 = fma(y2, xm, _P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LN2_LO)
    out = (xm - x2 * 0.5) + y
    return out + e * _LN2_HI
