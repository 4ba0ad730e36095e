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


def _polynomial(x: torch.Tensor, coefficients) -> torch.Tensor:
    """Horner's rule from the highest degree, one fused multiply-add a step
    (XLA's ``EvaluatePolynomial`` as the reference's CPU code runs it)."""
    p = torch.zeros_like(x)
    for c in coefficients:
        p = fma(p, x, c)
    return p


# Cephes log1p: log(1 + x) ≈ x − x²/2 + x³·P(x)/Q(x) for |x| < √2 − 1.
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553540525102e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)`` of float32 values > −1 as the reference's CPU code
    computes it: the Cephes rational for |x| < √2 − 1, else :func:`log` of
    ``x + 1``."""
    x2 = x * x
    r = (x * x2) * (_polynomial(x, _LOG1P_P) / _polynomial(x, _LOG1P_Q))
    small = x + fma(-0.5, x2, r)
    large = log(torch.clamp(x + 1.0, min=1e-30))
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


def _f32(v: float) -> float:
    """The float32 value nearest ``v``, as a Python float (so a product or
    sum with a float32 tensor rounds once, whichever precision torch
    computes it in)."""
    return float(torch.tensor(v, dtype=torch.float32))


_F32_1_7_5 = _f32(1.0 / 7.5)        # 1/(g + ½), a product as XLA folds it
_F32_LOG_7_5 = _f32(2.0149030205422647)

# Lanczos (g = 7) coefficients of XLA's digamma, as float32 constants.
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)


def digamma(x: torch.Tensor) -> torch.Tensor:
    """ψ(x) for float32 x ≥ 0.5, in the reference's order of operations
    (the Lanczos form ``chlo.digamma`` compiles to):
    ``log1p(z/7.5) + log 7.5 + num/den − 7/(z + 7.5)`` with ``z = x − 1``.
    Quotients are true divisions (torch's ``c / t`` with a Python ``c``
    multiplies by a reciprocal and rounds twice).  The reflection branch
    for x < 0.5 is not copied: those x give NaN (no caller passes them)."""
    z = x - 1.0
    num = torch.zeros_like(z)
    den = None
    for i, c in enumerate(_LANCZOS):
        zi = z + float(i + 1)
        coef = torch.full_like(z, c)
        num = num - coef / (zi * zi)
        den = coef / zi + 1.0 if den is None else den + coef / zi
    log_t = log1p(z * _F32_1_7_5) + _F32_LOG_7_5
    y = (log_t + num / den) - torch.full_like(z, 7.0) / (z + 7.5)
    return torch.where(x < 0.5, torch.nan, y)


_LIBM = None


def cos(x: torch.Tensor) -> torch.Tensor:
    """float32 ``cos`` as the reference's CPU code computes it.  XLA's CPU
    backend lowers ``cos`` to a call of the C library's ``cosf``, which is
    within one ulp but not correctly rounded, and ``torch.cos`` lands one
    ulp away on some arguments; the port calls the same function, an
    element at a time on the host, so it serves scalars such as a
    learning-rate schedule's and not whole tensors."""
    global _LIBM
    if _LIBM is None:
        import ctypes
        import ctypes.util
        _LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
        _LIBM.cosf.restype = ctypes.c_float
        _LIBM.cosf.argtypes = [ctypes.c_float]
    flat = x.detach().to(torch.float32).cpu().reshape(-1).tolist()
    out = torch.tensor([_LIBM.cosf(v) for v in flat], dtype=torch.float32)
    return out.reshape(x.shape).to(x.device)
