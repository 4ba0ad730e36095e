"""Parity of the port's flash-attention backward with the JAX reference on
the CPU.

The reference has no backward kernel: ``jax.grad`` differentiates the XLA
attention the model trains with (``repro/models/layers.py:_sdpa``).  On the
CPU, ``FlashAttention`` and ``FlashAttentionBackward`` take their plain
versions inside the same Functions the card runs, so these cases hold the
port's gradients and its saved row statistic to the reference directly.
Inputs are NumPy-made from a seed, float32.

Tolerances, each beside the gap measured on this CPU when it was set:
dq/dk/dv within ``GRAD_TOL`` = 1e-5 of each gradient's largest magnitude
against ``jax.vjp`` of ``_sdpa`` (gaps up to 4.1e-7; the two sum S terms in
another order); the output rebuilt from the saved logsumexp L,
exp(scale·Q·Kᵀ − L)·V, within 2e-5 of the reference oracle
``repro/kernels/flash_attention/ref.py:attention_ref`` (its own pin in
tests/test_kernels.py; absolute gaps up to 6.0e-7).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as jattention_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, FlashAttentionBackward)

GRAD_TOL = 1e-5
OUT_TOL = 2e-5

# (B, S, H, KV, D, causal, window): GQA groups 1 and 2, causal, windowed and
# not causal, ragged S (no multiple of the kernels' 64-row tiles), head_dim
# 16 and 64, and 96 (phi-3-vision-4.2b) and 192 (nemotron-4-340b), each
# causal with a window and not causal.
CASES = [
    (2, 24, 4, 4, 16, True, 0),
    (1, 37, 4, 2, 16, True, 5),
    (2, 20, 2, 1, 64, False, 0),
    (1, 33, 4, 2, 64, False, 6),
    (1, 37, 4, 2, 96, True, 9),
    (1, 33, 4, 2, 96, False, 0),
    (1, 37, 4, 2, 192, True, 9),
    (1, 33, 4, 2, 192, False, 0),
]
IDS = [f"S{c[1]}-H{c[2]}/{c[3]}-D{c[4]}-{'causal' if c[5] else 'full'}"
       f"-w{c[6]}" for c in CASES]


def _visible(s, causal, window):
    qpos, kpos = np.arange(s)[:, None], np.arange(s)[None, :]
    ok = np.ones((s, s), bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


def _inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, h, d)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", CASES, ids=IDS)
def test_backward_matches_jax_vjp_of_model_sdpa(b, s, h, kv, d, causal,
                                                window):
    q, k, v, do = _inputs(b, s, h, kv, d, seed=s + h + d)
    # _sdpa's additive mask: the reference's causal_mask where it applies.
    mask = jnp.asarray(np.where(_visible(s, causal, window), 0.0, -1e30)
                       .astype(np.float32))[None, None]
    want = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda *a: JL._sdpa(*a, mask, kv), q, k, v)[1](do))(
        *(jnp.asarray(x) for x in (q, k, v, do)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = FlashAttention.apply(tq, tk, tv, causal, window, True)
    got = FlashAttentionBackward.apply(tq, tk, tv, o, lse, tdo, causal,
                                       window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        gap = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert gap <= GRAD_TOL, (name, gap)


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", CASES, ids=IDS)
def test_saved_logsumexp_rebuilds_reference_output(b, s, h, kv, d, causal,
                                                   window):
    """P = exp(scale·Q·Kᵀ − L) from the L that ``FlashAttention`` saves
    for its backward gives the reference oracle's output."""
    q, k, v, _ = _inputs(b, s, h, kv, d, seed=s * h + d)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = FlashAttention.apply(tq, tk, tv, causal, window, True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    rep = h // kv
    kr, vr = (x.repeat_interleave(rep, dim=2) for x in (tk, tv))
    scores = torch.einsum("bqhd,bkhd->bhqk", tq, kr) / math.sqrt(d)
    ok = torch.from_numpy(_visible(s, causal, window))
    p = torch.where(ok, torch.exp(scores - lse[..., None]), 0.0)
    rebuilt = torch.einsum("bhqk,bkhd->bqhd", p, vr)

    def flat(x):
        return np.ascontiguousarray(np.swapaxes(x, 1, 2)).reshape(b * h, s, d)

    want = np.asarray(jattention_ref(
        *(jnp.asarray(flat(x)) for x in (q, np.repeat(k, rep, 2),
                                          np.repeat(v, rep, 2))),
        causal, window))
    want = np.swapaxes(want.reshape(b, h, s, d), 1, 2)
    np.testing.assert_allclose(rebuilt.numpy(), want, rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(o.numpy(), want, rtol=OUT_TOL, atol=OUT_TOL)


def test_forward_keeps_no_statistics_without_grad_mode():
    """Serving and evaluation run with grad mode off: the forward then asks
    for no L (the kernel writes none), and its output is the same."""
    from repro_torch.kernels.flash_attention import gqa_flash_attention
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 19, 4, 2, 16, 3))
    o, lse = FlashAttention.apply(q, k, v, True, 0, False)
    assert lse.shape == (2, 4, 0)
    with torch.no_grad():
        assert torch.equal(gqa_flash_attention(q, k, v), o)
    assert torch.equal(FlashAttention.apply(q, k, v, True, 0, True)[0], o)
