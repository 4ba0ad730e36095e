"""JAX's threefry2x32 keys in torch integer ops, bit-equal to ``jax.random``.

A key is an int64 tensor of shape ``(..., 2)`` holding two 32-bit words; a
leading batch of keys draws one sample each in a single call, so one call
serves every trial of a grid.  The layout is JAX's partitionable one
(``jax_threefry_partitionable = True``, the default of jax 0.9):

* ``PRNGKey(s) = (0, s mod 2^32)``;
* ``fold_in(k, d) = threefry(k, (0, d))``, and ``split(k, n)[i] =
  fold_in(k, i)``;
* the 32-bit bits of element i (row-major flat index) of a draw are
  ``y0 ^ y1`` with ``(y0, y1) = threefry(k, (i >> 32, i & 0xffffffff))``.

Each element's bits depend only on (key, i), so a caller may draw any subset
of a larger array by passing its flat indices (:func:`bits_at`) and get the
same numbers as the full draw.  Bits and uniforms are bit-equal to JAX's;
``normal`` is ``√2 · erf_inv(u)`` with a copy of XLA's float32 ``erf_inv``
(``core.ordered`` rounding), equal to JAX's but for about one draw in
50,000, which lands one or two ulp away.  ``gumbel`` and ``categorical``
take XLA's CPU ``log`` (``core.ordered.log``) and are bit-equal.

Torch has no unsigned 32-bit arithmetic on every device, so words live in
int64 and are masked back to 32 bits after each add and shift.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from .core.ordered import fma, log, log1p

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# Elements a draw hashes at once: bounds the int64 temporaries of a large
# draw (a grid round's image noise is hundreds of millions of elements).
_CHUNK = 1 << 24

KeyLike = Union[torch.Tensor, Sequence[int]]


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1) under
    the key (k0, k1); every argument an int64 tensor of 32-bit words, all
    broadcast together.  Returns the two output words.  The rounds update
    two buffers in place: a draw of millions of elements then makes no
    new allocation a step."""
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    if k0.device.type == "meta":      # shapes only (``init_model`` on meta)
        out = torch.empty(shape, dtype=torch.int64, device="meta")
        return out, out.clone()
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = ((x0 + ks[0]) & _MASK).expand(shape).contiguous()
    x1 = ((x1 + ks[1]) & _MASK).expand(shape).contiguous()
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)      # rotl(x1, r)
            x1.bitwise_left_shift_(r).bitwise_and_(_MASK).bitwise_or_(tmp)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return x0, x1


def as_key(key: KeyLike, device=None) -> torch.Tensor:
    """A key (or a batch of keys) as an int64 ``(..., 2)`` tensor."""
    k = torch.as_tensor(key, dtype=torch.int64, device=device)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key has shape (..., 2); got {tuple(k.shape)}")
    return k


@torch.library.custom_op("repro_torch::random_seed", mutates_args=())
def random_seed(seed: torch.Tensor) -> torch.Tensor:
    """int64 seeds (…) -> keys (…, 2) ``(0, seed mod 2^32)``.  One op of its
    own, as JAX's ``random_seed`` primitive is, so that a key built from a
    seed inside a traced body is one node of the graph
    (``repro_torch.analysis`` flags it, A006)."""
    s = seed & _MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


@random_seed.register_fake
def _random_seed_fake(seed: torch.Tensor) -> torch.Tensor:
    return seed.new_empty(seed.shape + (2,))


def PRNGKey(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey``: an int seed (or a tensor of seeds) -> keys
    ``(0, seed mod 2^32)``, as JAX forms them with 64-bit types off."""
    return random_seed(torch.as_tensor(seed, dtype=torch.int64,
                                       device=device))


def fold_in(key: KeyLike, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys (..., 2) and an int (or a tensor of ints
    broadcast against the keys' batch) -> keys (..., 2)."""
    key = as_key(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: KeyLike, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., num, 2)."""
    key = as_key(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], i)


def bits_at(key: KeyLike, index: torch.Tensor) -> torch.Tensor:
    """The 32-bit bits (int64 values in [0, 2^32)) of the elements at the
    int64 flat ``index`` of a draw under ``key``, broadcast together: the
    same numbers ``random_bits`` gives those elements of the whole array."""
    key = as_key(key)
    index = index.to(torch.int64)
    k0, k1 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k0, k1, index >> 32, index & _MASK)
    return y0.bitwise_xor_(y1)


def random_bits(key: KeyLike, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): keys (B..., 2) -> (B..., *shape) int64
    values in [0, 2^32)."""
    key = as_key(key)
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return bits_at(key[..., None, :], idx).reshape(key.shape[:-1] + shape)


_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def randint(key: KeyLike, shape: Sequence[int], minval, maxval
            ) -> torch.Tensor:
    """``jax.random.randint`` with int32 output: keys (B..., 2) and bounds
    (ints, or int tensors broadcast against ``shape``) -> (B..., *shape)
    int32 in [minval, maxval).

    JAX's algorithm: 32 higher and 32 lower bits from the two halves of
    ``split(key)``, span = maxval − minval as uint32 (1 where maxval ≤
    minval), multiplier = (2^16 mod span)² mod span, and the offset
    ((hi mod span)·multiplier + lo mod span) mod span, every step wrapping
    at 2^32 as uint32 does.  Bounds must lie in int32."""
    key = as_key(key)
    lo_b = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    hi_b = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    for b in (lo_b, hi_b):
        if bool(((b < _INT32_MIN) | (b > _INT32_MAX)).any()):
            raise ValueError("randint bounds must lie in int32")
    k = split(key, 2)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    span = (hi_b - lo_b) & _MASK
    span = torch.where(hi_b <= lo_b, torch.ones_like(span), span)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    offset = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    out = (lo_b + offset % span) & _MASK
    return torch.where(out > _INT32_MAX, out - (1 << 32), out).to(torch.int32)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 in [0, 1): the top 23 bits as the mantissa of a
    number in [1, 2), minus one (JAX's ``uniform``)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _scale(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(lo, u·(hi − lo) + lo)`` in float32 with one rounding for the
    multiply-add, as the reference's CPU code fuses it."""
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, fma(u, hi - lo, lo))


def uniform(key: KeyLike, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: keys (B..., 2) -> (B..., *shape)."""
    return _scale(bits_to_unit(random_bits(key, shape)), minval, maxval)


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w = −log1p(−x²), one set of coefficients below
# w = 5 (in w − 2.5) and one above (in √w − 3).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (what ``jax.lax.erf_inv`` compiles to), with
    ±1 mapped to ±inf as XLA maps it: the reference's ``log1p`` and one
    fused multiply-add a Horner step.  Only its ``sqrt`` differs (XLA's CPU
    one is not correctly rounded on ~0.6% of inputs), which moves about
    one draw in 50,000 by one ulp."""
    w = -log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, torch.where(lt, lt5[i], ge5[i]))
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


_NORMAL_LO = -0.99999994  # nextafter(−1, 0) in float32
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))


def unit_to_normal(u: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) float32 -> JAX's standard normal: scaled onto
    [nextafter(−1, 0), 1), then √2 · erf_inv."""
    return _SQRT2 * erf_inv(_scale(u, _NORMAL_LO, 1.0))


def normal_rows(keys: KeyLike, offsets: torch.Tensor,
                width: int) -> torch.Tensor:
    """Rows of standard normals: row r holds elements ``offsets[r]`` ..
    ``offsets[r] + width − 1`` of a draw under ``keys[r]`` (keys (…, 2),
    offsets (…,) int) -> (…, width) float32.  Hashed a block of rows at a
    time, so the int64 temporaries stay near ``_CHUNK`` elements however
    many rows are asked for."""
    keys = as_key(keys)
    offsets = torch.as_tensor(offsets, dtype=torch.int64, device=keys.device)
    lead = torch.broadcast_shapes(keys.shape[:-1], offsets.shape)
    keys = keys.expand(lead + (2,)).reshape(-1, 2)
    offsets = offsets.expand(lead).reshape(-1)
    cols = torch.arange(width, dtype=torch.int64, device=keys.device)
    out = torch.empty((offsets.numel(), width), dtype=torch.float32,
                      device=keys.device)
    step = max(1, _CHUNK // max(width, 1))
    for r in range(0, offsets.numel(), step):
        sl = slice(r, r + step)
        idx = offsets[sl, None] + cols
        out[sl] = unit_to_normal(bits_to_unit(bits_at(keys[sl, None, :],
                                                      idx)))
    return out.reshape(lead + (width,))


def normal(key: KeyLike, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: keys (B..., 2) -> (B..., *shape).
    A draw larger than ``_CHUNK`` elements is hashed as rows of ``_CHUNK``,
    so a full-width embedding table stays within the same temporaries."""
    key = as_key(key)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    width = max(1, min(n, _CHUNK))
    offsets = torch.arange(-(-n // width), dtype=torch.int64,
                           device=key.device) * width
    flat = normal_rows(key[..., None, :], offsets, width)
    return flat.reshape(key.shape[:-1] + (-1,))[..., :n].reshape(
        key.shape[:-1] + shape)


_TINY = float(torch.finfo(torch.float32).tiny)


def _gumbel_at(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """JAX's low-range gumbel of the elements at flat ``idx`` of a draw
    under ``keys``: ``−log(−log(u))`` with u uniform on [tiny, 1)."""
    u = _scale(bits_to_unit(bits_at(keys, idx)), _TINY, 1.0)
    return -log(-log(u))


def gumbel(key: KeyLike, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (mode "low", JAX's default): keys
    (B..., 2) -> (B..., *shape)."""
    key = as_key(key)
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return _gumbel_at(key[..., None, :], idx).reshape(key.shape[:-1] + shape)


def categorical_rows(keys: KeyLike, offsets: torch.Tensor,
                     logits: torch.Tensor, num: int) -> torch.Tensor:
    """Rows of categorical draws: row r holds ``num`` draws from
    ``logits[r]`` (…, V), each the argmax over V of the logits plus the
    gumbels at elements ``offsets[r] + i·V`` … ``+ V − 1`` of a draw under
    ``keys[r]`` -> (…, num) int64.  That is ``jax.random.categorical(k,
    logits[..., None, :], shape=(…, num))`` row by row, where row r sits at
    counter offset ``offsets[r]`` of the whole draw; hashed a block of rows
    at a time, as :func:`normal_rows` is."""
    keys = as_key(keys)
    offsets = torch.as_tensor(offsets, dtype=torch.int64, device=keys.device)
    v = logits.shape[-1]
    lead = torch.broadcast_shapes(keys.shape[:-1], offsets.shape,
                                  logits.shape[:-1])
    keys = keys.expand(lead + (2,)).reshape(-1, 2)
    offsets = offsets.expand(lead).reshape(-1)
    logits = logits.to(torch.float32).expand(lead + (v,)).reshape(-1, v)
    cols = torch.arange(num * v, dtype=torch.int64, device=keys.device)
    out = torch.empty((offsets.numel(), num), dtype=torch.int64,
                      device=keys.device)
    step = max(1, _CHUNK // max(num * v, 1))
    for r in range(0, offsets.numel(), step):
        sl = slice(r, r + step)
        g = _gumbel_at(keys[sl, None, :], offsets[sl, None] + cols)
        out[sl] = (g.reshape(-1, num, v) + logits[sl, None, :]).argmax(-1)
    return out.reshape(lead + (num,))


def categorical(key: KeyLike, logits: torch.Tensor,
                shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1, shape)`` (with
    replacement, the gumbel-max draw) for one key -> int64 of ``shape``
    (default ``logits.shape[:-1]``): the argmax over the last axis of
    ``gumbel(key, shape + (V,))`` plus the logits broadcast against it."""
    key = as_key(key)
    if key.dim() != 1:
        raise ValueError("categorical takes one key; categorical_rows takes "
                         "a key a row")
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else tuple(int(s) for s in shape)
    torch.broadcast_shapes(shape, batch)          # raises if incompatible
    g = gumbel(key, shape + (logits.shape[-1],))
    return (g + logits.to(torch.float32)).argmax(-1)
