"""Model building blocks of the serving path: norms, RoPE, GQA attention
(qk-norm / bias / sliding window), gated and relu² MLPs, the top-k
mixture of experts, the Mamba2 SSD mixer, embedding and unembedding.

Mirrors ``repro/models/layers.py`` function for function.  Parameters are
plain dicts of tensors in the reference's layouts (``wq`` (d, H, hd), ``wo``
(H, hd, d), dense weights (in, out), the embedding table (V, d)), so the
reference's weights carry over unchanged (``repro_torch.convert``).  The
``*_init`` functions draw from ``repro_torch.rng`` keys with the reference's
split tree, so they give the reference's weights (to the ulp level ``rng``
states for normals); a batch of keys (…, 2) gives a batch of models.  The
reference's ``*_init`` also return logical sharding specs; the port runs on
one card and returns the params alone.

Where the reference runs plain XLA, the port runs plain PyTorch (the MoE's
routing, dispatch and batched expert products, cross-attention) or the
hand-written kernels: attention in the ``train`` and ``prefill`` modes goes
through ``gqa_flash_attention`` for both ``attention_impl`` values
(``dense`` and ``chunked`` compute the same function), and the Mamba
mixer's scan through ``ssd_apply``.  Both are differentiable (``torch.autograd.Function``s whose
backward is the flash backward kernel pair, and the plain chunked SSD's
vjp) and batch under ``torch.func.vmap`` into one launch.  Decode stays
plain PyTorch, as the reference computes it outside any Pallas kernel.
Caches are updated in place (the reference returns new arrays): a decode
step writes one slot instead of copying the whole cache.  A cache's ``idx``
is a Python int.

Conventions: params in ``cfg.dtype``; softmax, norms and the SSD accumulate
in float32; attention caches hold RoPE'd keys at absolute positions.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import rng
from .. import sharding as sh
from ..kernels.flash_attention import gqa_flash_attention
from ..kernels.ssd_scan import ssd_apply
from .config import ModelConfig

Params = Dict[str, Any]
Cache = Dict[str, Any]

NEG_INF = -1e30


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _lead(key: torch.Tensor) -> Tuple[int, ...]:
    """The batch shape of a key (…, 2)."""
    return tuple(key.shape[:-1])


def dense_init(key: torch.Tensor, shape: Tuple[int, ...],
               dtype: torch.dtype, in_axis: int = 0,
               scale: float = 1.0) -> torch.Tensor:
    """Normal(0, scale / sqrt(shape[in_axis])) drawn in float32 from ``key``
    on the key's device, then cast to ``dtype``; keys (…, 2) -> (…,
    *shape)."""
    if key.device.type == "meta":     # shapes only (``param_count``)
        return torch.empty(_lead(key) + tuple(shape), dtype=dtype,
                           device="meta")
    std = float(torch.tensor(scale / math.sqrt(shape[in_axis]),
                             dtype=torch.float32))
    return rng.normal(key, shape).mul_(std).to(dtype)


def _full(key: torch.Tensor, shape: Tuple[int, ...], value: float,
          dtype: torch.dtype) -> torch.Tensor:
    return torch.full(_lead(key) + tuple(shape), value, dtype=dtype,
                      device=key.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(key: torch.Tensor, d: int, dtype: torch.dtype) -> Params:
    """Ones (d,), batched like ``key`` (only its shape and device are
    read)."""
    return {"scale": _full(key, (d,), 1.0, dtype)}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5
                  ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def headwise_norm_apply(scale: torch.Tensor, x: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: RMS over head_dim of (..., heads, head_dim)."""
    return rmsnorm_apply({"scale": scale}, x, eps)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (B, S, H, D) with D even; positions (B, S) absolute indices."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(theta, exps)    # a Python base: no host-to-card copy
    angle = positions.float()[..., None, None] * freq        # (B, S, 1, half)
    cos, sin = torch.cos(angle), torch.sin(angle)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_init(key: torch.Tensor, cfg: ModelConfig) -> Params:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    dt = _dtype(cfg)
    ks = rng.split(key, 4)
    params: Params = {
        "wq": dense_init(ks[..., 0, :], (d, h, hd), dt),
        "wk": dense_init(ks[..., 1, :], (d, kv, hd), dt),
        "wv": dense_init(ks[..., 2, :], (d, kv, hd), dt),
        "wo": dense_init(ks[..., 3, :], (h, hd, d), dt, in_axis=0,
                         scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qkv_bias:
        params["bq"] = _full(key, (h, hd), 0.0, dt)
        params["bk"] = _full(key, (kv, hd), 0.0, dt)
        params["bv"] = _full(key, (kv, hd), 0.0, dt)
    if cfg.qk_norm:
        params["q_norm"] = _full(key, (hd,), 1.0, dt)
        params["k_norm"] = _full(key, (hd,), 1.0, dt)
    return params


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, heads, hd) -> (B, S, heads, hd) as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = headwise_norm_apply(p["q_norm"], q, cfg.norm_eps)
        k = headwise_norm_apply(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) x (H, hd, d) -> (B, S, d) as one matmul."""
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], num_kv: int) -> torch.Tensor:
    """Grouped scaled-dot-product attention, plain (decode and
    cross-attention).  q (B, Sq, H, D), k/v (B, Sk, KV, D) with a key length
    of their own, mask additive float32 broadcastable to (B, 1, Sq, Sk) or
    None.  Probabilities are rounded to v's dtype before P·V, as in the
    reference."""
    b, sq, h, d = q.shape
    groups = h // num_kv
    qg = q.reshape(b, sq, num_kv, groups, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores / math.sqrt(d)
    if mask is not None:
        scores = scores + mask[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)


def causal_mask(sq: int, sk: int, q_offset: int = 0, window: int = 0,
                device: "torch.device | str" = "cpu") -> torch.Tensor:
    """Additive (1, 1, Sq, Sk) mask: q position i (absolute i+q_offset) may
    attend to k position j iff j <= i+off and (window == 0 or
    j > i+off-window)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > (qpos - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, NEG_INF)[None, None]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> Cache:
    dt = _dtype(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, max_len, kv, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, hd), dtype=dt,
                             device=device),
            "idx": 0}


def kv_cache_specs() -> Dict[str, tuple]:
    """The logical axes of :func:`init_kv_cache`'s leaves; ``idx`` (a host
    int) is a scalar, ``()``."""
    return {"k": (sh.BATCH, sh.KV_SEQ, sh.KV_HEADS, None),
            "v": (sh.BATCH, sh.KV_SEQ, sh.KV_HEADS, None),
            "idx": ()}


def attention_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    mode: str = "train", cache: Optional[Cache] = None,
                    window: int = 0
                    ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Self-attention.  mode:
       train   — full causal (or sliding-window) over x, no cache;
       prefill — as train, and writes x's K/V into ``cache``;
       decode  — x is (B, 1, d); attends to the cache and itself; updates
                 the cache.
    """
    b, s, _ = x.shape
    if mode in ("train", "prefill"):
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q, k, v = _qkv(p, x, cfg, positions)
        out = gqa_flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True, window=window)
        new_cache = None
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill needs a cache")
            ck, cv = cache["k"], cache["v"]
            max_len = ck.shape[1]
            if window and max_len == window and s > window:
                # Ring-buffer window cache: token t lives at slot t % window,
                # so that later decode steps evict the oldest token.
                shift = s % window
                ck.copy_(torch.roll(k[:, s - window:], shifts=shift, dims=1))
                cv.copy_(torch.roll(v[:, s - window:], shifts=shift, dims=1))
            else:
                ck[:, :s] = k
                cv[:, :s] = v
            new_cache = {"k": ck, "v": cv, "idx": s}
        return _out(out, p["wo"]), new_cache

    if mode != "decode" or cache is None or s != 1:
        raise ValueError(f"decode takes one token and a cache; got mode "
                         f"{mode!r}, S={s}, cache {cache is not None}")
    idx = cache["idx"]                       # tokens already in the cache
    ck, cv = cache["k"], cache["v"]
    max_len = ck.shape[1]
    positions = torch.full((b, 1), idx, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    ring = bool(window) and max_len == window
    slot = idx % max_len if ring else idx
    ck[:, slot:slot + 1] = k
    cv[:, slot:slot + 1] = v
    live = min(idx + 1, max_len) if ring else idx + 1
    kpos = torch.arange(max_len, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask = torch.where(kpos < live, zero, NEG_INF)[None, None, None, :]
    out = _sdpa(q, ck, cv, mask, cfg.num_kv_heads)
    return _out(out, p["wo"]), {"k": ck, "v": cv, "idx": idx + 1}


# ---------------------------------------------------------------------------
# Cross-attention (the whisper decoder)
# ---------------------------------------------------------------------------
# The reference computes it with its XLA ``_sdpa`` outside any Pallas kernel,
# and its flash kernel takes one length for queries and keys, so the port
# keeps it plain PyTorch (``_sdpa``) in every mode.

def cross_attention_init(key: torch.Tensor, cfg: ModelConfig) -> Params:
    """The weights of :func:`attention_init` (same shapes, same draws)."""
    return attention_init(key, cfg)


def cross_attention_apply(p: Params, x: torch.Tensor,
                          enc_kv: Tuple[torch.Tensor, torch.Tensor],
                          cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) decoder states; enc_kv the precomputed (K, V), each
    (B, F, KV, hd).  q from ``wq`` (plus ``bq``), no RoPE and no qk-norm,
    attending to every frame."""
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    out = _sdpa(q, enc_kv[0], enc_kv[1], None, cfg.num_kv_heads)
    return _out(out, p["wo"])


def encode_cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output (B, F, d) -> cross-attention's (K, V), each
    (B, F, KV, hd), from ``wk``/``wv`` (plus ``bk``/``bv``)."""
    k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


# ---------------------------------------------------------------------------
# MLP (gated silu/gelu, or squared-ReLU non-gated)
# ---------------------------------------------------------------------------

def _activation(name: str):
    if name == "silu_glu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation.
    return lambda t: F.gelu(t, approximate="tanh")


def mlp_init(key: torch.Tensor, cfg: ModelConfig, d_ff: int) -> Params:
    d, dt = cfg.d_model, _dtype(cfg)
    ks = rng.split(key, 3)
    out_scale = 1.0 / math.sqrt(2 * cfg.num_layers)
    if cfg.activation == "relu2":
        return {"w1": dense_init(ks[..., 0, :], (d, d_ff), dt),
                "w2": dense_init(ks[..., 1, :], (d_ff, d), dt,
                                 scale=out_scale)}
    return {"w_gate": dense_init(ks[..., 0, :], (d, d_ff), dt),
            "w_up": dense_init(ks[..., 1, :], (d, d_ff), dt),
            "w2": dense_init(ks[..., 2, :], (d_ff, d), dt, scale=out_scale)}


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "relu2":
        h = torch.square(F.relu(x @ p["w1"]))
    else:
        act = _activation(cfg.activation)
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based dispatch with capacity, as the reference)
# ---------------------------------------------------------------------------

def moe_init(key: torch.Tensor, cfg: ModelConfig) -> Params:
    """The router (d, E) in float32 whatever ``cfg.dtype``, and the experts'
    gated MLPs (E, d, ff), (E, d, ff), (E, ff, d), drawn from ``split(key,
    4)`` as the reference draws them (the gate and up weights scaled by
    their leading axis, E, as its ``dense_init`` default does)."""
    d, e, dt = cfg.d_model, cfg.num_experts, _dtype(cfg)
    ff = cfg.moe_d_ff or cfg.d_ff
    ks = rng.split(key, 4)
    return {
        "router": dense_init(ks[..., 0, :], (d, e), torch.float32),
        "w_gate": dense_init(ks[..., 1, :], (e, d, ff), dt),
        "w_up": dense_init(ks[..., 2, :], (e, d, ff), dt),
        "w2": dense_init(ks[..., 3, :], (e, ff, d), dt, in_axis=1,
                         scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }


def _expert_act(cfg: ModelConfig):
    """The experts' gate activation: silu unless ``gelu_glu`` (a relu²
    config's experts are gated silu MLPs, as in the reference)."""
    return _activation("gelu_glu" if cfg.activation == "gelu_glu"
                       else "silu_glu")


def _expert_ffn(p: Params, xb: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """xb (E, Cap, d) -> (E, Cap, d): each expert's gated MLP on its buffer,
    as batched products."""
    act = _expert_act(cfg)
    h = act(torch.matmul(xb, p["w_gate"])) * torch.matmul(xb, p["w_up"])
    return torch.matmul(h, p["w2"])


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert's buffer has for ``tokens`` tokens:
    ceil(k·t·capacity_factor / E), rounded up to a multiple of 8, at
    least 8."""
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = int(math.ceil(k * tokens * cfg.capacity_factor / e))
    return max(8, -(-cap // 8) * 8)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE over the flattened tokens: x (B, S, d) -> (y, aux).

    The router runs in float32; the gates are the softmax's top k (ties to
    the lower expert id, as ``jax.lax.top_k``: a stable descending sort)
    renormalised by max(sum, 1e-9).  aux is the Switch load-balance loss
    E · Σ_e f_e · p̄_e, f_e counting top-1 choices.  With ``moe_dropless``
    every token's k experts contribute (an all-experts product weighted by
    a (t, E) combine matrix); otherwise the assignments, sorted stably by
    expert, fill (E, cap) buffers in that order, those past ``cap`` are
    dropped (they contribute exactly zero), the experts run as batched
    products and the outputs are summed back per token.  Out-of-place
    scatters only, so ``torch.func.vmap`` and ``grad`` go through; under
    vmap t and cap are a client's own."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    sorted_p, sorted_i = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_vals, gate_idx = sorted_p[:, :k], sorted_i[:, :k]       # (t, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    experts = torch.arange(e, device=x.device)
    me = (gate_idx[:, :1] == experts).float().mean(0)
    aux = e * torch.sum(me * probs.mean(0))

    if cfg.moe_dropless:
        combine = torch.zeros((t, e), dtype=torch.float32,
                              device=x.device).scatter_add(1, gate_idx,
                                                           gate_vals)
        # (E, t, ff) products against the weights in place (an einsum
        # would copy each (E, d, ff) weight into its own layout), then one
        # contraction over (E, ff) as the reference's einsum takes it.
        act = _expert_act(cfg)
        g = torch.matmul(xt, p["w_gate"]).transpose(0, 1)
        u = torch.matmul(xt, p["w_up"]).transpose(0, 1)
        h = act(g) * u * combine.to(x.dtype)[..., None]
        y = torch.einsum("tef,efd->td", h, p["w2"])
        return y.reshape(b, s, d), aux

    cap = moe_capacity(cfg, t)
    flat_e = gate_idx.reshape(-1)                                  # (t·k,)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_g = gate_vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = (flat_e[:, None] == experts).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=x.device) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, 0)        # dropped: slot 0, x 0
    xbuf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    xbuf = xbuf.index_add(0, slot, xt[st] * keep[:, None].to(x.dtype))
    ybuf = _expert_ffn(p, xbuf.reshape(e, cap, d), cfg).reshape(e * cap, d)
    contrib = ybuf[slot] * (sg * keep)[:, None].to(x.dtype)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    y = y.index_add(0, st, contrib)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD) mixer
# ---------------------------------------------------------------------------

def mamba_init(key: torch.Tensor, cfg: ModelConfig) -> Params:
    d, dt = cfg.d_model, _dtype(cfg)
    din, h, n, g = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = din + 2 * g * n
    ks = rng.split(key, 5)
    f32 = dict(dtype=torch.float32, device=key.device)
    # The reference's float32 constants: log(linspace) and log(expm1(0.01)).
    a_log = torch.log(torch.linspace(1.0, 16.0, h, **f32))
    dt_bias = torch.log(torch.expm1(torch.full((h,), 0.01, **f32)))
    return {
        "in_proj": dense_init(ks[..., 0, :], (d, 2 * din + 2 * g * n + h), dt),
        "conv_w": dense_init(ks[..., 1, :], (cfg.ssm_conv_width, conv_dim),
                             dt, in_axis=0),
        "conv_b": _full(key, (conv_dim,), 0.0, dt),
        "A_log": a_log.expand(_lead(key) + (h,)).clone(),
        "D": _full(key, (h,), 1.0, torch.float32),
        "dt_bias": dt_bias.expand(_lead(key) + (h,)).clone(),
        "norm_scale": _full(key, (din,), 1.0, dt),
        "out_proj": dense_init(ks[..., 4, :], (din, d), dt,
                               scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device: torch.device) -> Cache:
    din, h, n, g = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = din + 2 * g * n
    return {"conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                                dtype=_dtype(cfg), device=device),
            "state": torch.zeros((batch, h, cfg.ssm_head_dim, n),
                                 dtype=torch.float32, device=device),
            "idx": 0}


def ssm_cache_specs() -> Dict[str, tuple]:
    """The logical axes of :func:`init_ssm_cache`'s leaves."""
    return {"conv": (sh.BATCH, None, sh.SSM_INNER),
            "state": (sh.BATCH, None, None, sh.SSM_STATE),
            "idx": ()}


def _mamba_split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din, g, n, h = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [din, din + 2 * g * n, h], dim=-1)


def mamba_apply(p: Params, u: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "train", cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Mamba2 block.  u (B, S, d_model); decode: S == 1 with a cache."""
    b, s, _ = u.shape
    din, g, n, h, pdim = (cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state,
                          cfg.ssm_heads, cfg.ssm_head_dim)
    cw = cfg.ssm_conv_width
    z, xBC, dt = _mamba_split(cfg, u @ p["in_proj"])
    A = -torch.exp(p["A_log"])                                  # (H,) < 0
    dt_full = F.softplus(dt.float() + p["dt_bias"])

    if mode in ("train", "prefill"):
        pad = torch.zeros((b, cw - 1, xBC.shape[-1]), dtype=xBC.dtype,
                          device=u.device)
        xpad = torch.cat([pad, xBC], dim=1)
        w = p["conv_w"].float()
        conv = sum(xpad[:, i:i + s].float() * w[i] for i in range(cw))
        conv = F.silu(conv.to(xBC.dtype) + p["conv_b"])
        xs, B, C = torch.split(conv, [din, g * n, g * n], dim=-1)
        xh = xs.reshape(b, s, h, pdim).float()
        Bm = B.reshape(b, s, g, n).float()
        Cm = C.reshape(b, s, g, n).float()
        pad_to = -s % cfg.ssm_chunk
        # Padded steps have dt = 0: decay 1 and no update, so the final
        # state is the state after the last real token.
        xk, dtk, Bk, Ck = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad_to))
                           for t in (xh, dt_full, Bm, Cm))
        y, final = ssd_apply(xk.contiguous(), dtk.contiguous(), A,
                             Bk.contiguous(), Ck.contiguous(),
                             chunk=cfg.ssm_chunk)
        y = y[:, :s] + xh * p["D"][None, None, :, None]
        y = y.reshape(b, s, din).to(u.dtype)
        new_cache = None
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill needs a cache")
            cache["conv"].copy_(xpad[:, s:])   # the trailing cw-1 inputs
            cache["state"].copy_(final)
            new_cache = {"conv": cache["conv"], "state": cache["state"],
                         "idx": s}
    else:
        if mode != "decode" or cache is None or s != 1:
            raise ValueError(f"decode takes one token and a cache; got mode "
                             f"{mode!r}, S={s}, cache {cache is not None}")
        conv_buf = torch.cat([cache["conv"], xBC], dim=1)          # (b, cw, c)
        conv = torch.einsum("bwc,wc->bc", conv_buf.float(),
                            p["conv_w"].float())
        conv = F.silu(conv.to(xBC.dtype) + p["conv_b"])[:, None, :]
        xs, B, C = torch.split(conv, [din, g * n, g * n], dim=-1)
        xh = xs.reshape(b, h, pdim).float()
        Bm = B.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()
        Cm = C.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()
        dt1 = dt_full[:, 0]                                        # (b, h)
        decay = torch.exp(dt1 * A)[:, :, None, None]
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt1, xh, Bm)
        state = cache["state"] * decay + upd
        y = (torch.einsum("bhpn,bhn->bhp", state, Cm)
             + xh * p["D"][None, :, None])
        y = y.reshape(b, 1, din).to(u.dtype)
        cache["conv"].copy_(conv_buf[:, 1:])
        cache["state"].copy_(state)
        new_cache = {"conv": cache["conv"], "state": cache["state"],
                     "idx": cache["idx"] + 1}

    # Gated RMSNorm, then the out-projection.
    gated = y * F.silu(z.float()).to(y.dtype)
    gated = rmsnorm_apply({"scale": p["norm_scale"]}, gated, cfg.norm_eps)
    return gated @ p["out_proj"], new_cache


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(key: torch.Tensor, cfg: ModelConfig) -> Params:
    return {"table": dense_init(key, (cfg.vocab_size, cfg.d_model),
                                _dtype(cfg), in_axis=1)}


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T
