"""Plain PyTorch versions of the flash-attention kernels: causal (optionally
sliding-window) attention with the whole score matrix, forward and
backward.  They compute in float32 (float64 for float64 inputs, so that
``torch.autograd.gradcheck`` can hold the backward to the forward)."""
from __future__ import annotations

import math

import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _visible(s: int, causal: bool, window: int,
             device: torch.device) -> torch.Tensor:
    """(S, S) bool: query i sees key j iff ``j <= i`` (causal) and
    ``j > i - window`` (window > 0)."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int, with_lse: bool):
    """q/k/v (BH, S, D) -> (o (BH, S, D) in q's dtype, each row's logsumexp
    of the scaled, masked scores (BH, S) in the accumulation dtype, or None
    without ``with_lse``)."""
    _, s, d = q.shape
    acc = _acc(q.dtype)
    scores = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) / math.sqrt(d)
    ok = _visible(s, causal, window, q.device)
    scores = scores.masked_fill(~ok[None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", probs, v.to(acc)).to(q.dtype)
    return out, torch.logsumexp(scores, dim=-1) if with_lse else None


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q/k/v (BH, S, D) -> (BH, S, D) in q's dtype."""
    return _attention(q, k, v, causal, window, False)[0]


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0, *,
                      with_lse: bool = False):
    """q (B, S, H, D), k/v (B, S, KV, D) -> (B, S, H, D): q-head h reads
    kv-head ``h // (H // KV)``, as the reference repeats K/V per head.  With
    ``with_lse``, also each row's logsumexp L of the scaled, masked scores,
    (B, H, S) in float32 (float64 for float64 inputs): the statistic the
    kernels' backward reads, P = exp(scale·Q·Kᵀ − L)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]

    def flat(x):
        return x.transpose(1, 2).reshape(b * h, s, d)

    out, lse = _attention(flat(q), flat(k.repeat_interleave(rep, dim=2)),
                          flat(v.repeat_interleave(rep, dim=2)), causal,
                          window, with_lse)
    out = out.reshape(b, h, s, d).transpose(1, 2)
    return (out, lse.reshape(b, h, s)) if with_lse else out


def gqa_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, do: torch.Tensor,
                          causal: bool = True, window: int = 0):
    """The gradients of :func:`gqa_attention_ref` -> (dq (B, S, H, D),
    dk, dv (B, S, KV, D)), each in its input's dtype.  With P the softmax
    probabilities, Δ = rowsum(dO∘O) and dS = P∘(dO·Vᵀ − Δ): dQ = dS·K/√D,
    dK = dSᵀ·Q/√D summed over the kv-head's group, dV = Pᵀ·dO likewise, as
    the kernel pair computes them."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    acc = _acc(q.dtype)
    qf, of, dof = (x.to(acc).reshape(b, s, kvh, g, d) for x in (q, o, do))
    kf, vf = k.to(acc), v.to(acc)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) / math.sqrt(d)
    ok = _visible(s, causal, window, q.device)
    p = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)           # (b, kv, g, q)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) / math.sqrt(d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) / math.sqrt(d)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
