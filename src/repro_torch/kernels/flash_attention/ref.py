"""Plain PyTorch version of the flash-attention kernel: causal (optionally
sliding-window) attention with the whole score matrix in float32."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q/k/v (BH, S, D) -> (BH, S, D) in q's dtype.  Query i sees key j iff
    ``j <= i`` (causal) and ``j > i - window`` (window > 0)."""
    _, s, d = q.shape
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    scores = scores.masked_fill(~ok[None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, KV, D) -> (B, S, H, D): q-head h reads
    kv-head ``h // (H // KV)``, as the reference repeats K/V per head."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]

    def flat(x):
        return x.transpose(1, 2).reshape(b * h, s, d)

    out = attention_ref(flat(q), flat(k.repeat_interleave(rep, dim=2)),
                        flat(v.repeat_interleave(rep, dim=2)), causal, window)
    return out.reshape(b, h, s, d).transpose(1, 2)
