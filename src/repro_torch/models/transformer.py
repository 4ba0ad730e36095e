"""The model stack of the serving and training paths: an input pathway
(text tokens; a VLM's projected patch embeddings before the text; an audio
encoder over frame embeddings whose K/V the decoder cross-attends) -> N
blocks (mixer in {attn, mamba} x ffn in {dense, moe, moe+dense, none}) ->
final norm -> unembed.

Mirrors ``repro/models/transformer.py``.  The reference stacks the blocks of
a homogeneous stack on a leading repeat axis and ``lax.scan``s over params
and caches together (``scan_layers=True``); the port keeps a per-layer list
of block params and a per-layer list of caches and runs a Python loop;
``stack_plan`` describes the reference's layout (for
``repro_torch.convert``) and its superblocks, which the training forward
checkpoints as the reference does (``cfg.remat``, ``cfg.remat_policy``:
``stack_apply_train``).  The reference's sharding constraints are
single-device no-ops and are dropped.  The encoder-decoder (whisper) is
unrolled in the reference too: its encoder and decoder blocks are tuples a
layer, here lists.  The audio encoder's bidirectional attention goes
through the flash kernel with ``causal=False``; cross-attention stays plain
(``layers.cross_attention_apply``).

Weights are drawn from ``repro_torch.rng`` keys with the reference's split
tree (``init_model``: ``split(key, 6)``; the stack's blocks as
``stack_plan`` lays them out; the projector, encoder and cross-attending
decoder from slots 2-5), so a key gives the reference's model.

Entry points:
    loss_fn(params, cfg, batch)               — training loss (next-token CE)
    forward(params, cfg, batch)               — full-sequence logits
    prefill(params, cfg, batch, max_len)      — last logits and the caches
    decode_step(params, cfg, tokens, caches)  — one token, cache-resident
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from .. import rng
from ..device import resolve_device
from ..kernels.flash_attention import gqa_flash_attention
from . import layers as L
from .config import ModelConfig

Params = Dict[str, Any]
Kind = Tuple[str, str]
# The encoder-decoder's blocks (encoder and decoder alike).
ENC_DEC_KIND: Kind = ("attn", "dense")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def block_init(key: torch.Tensor, cfg: ModelConfig, kind: Kind,
               cross_attention: bool = False) -> Params:
    """One block from ``key``: ``split(key, 6)``, the mixer from slot 0, a
    decoder block's cross-attention from slot 1, the MLP or the MoE from
    slot 2 and a ``moe+dense`` block's residual MLP from slot 3, as the
    reference draws them."""
    mixer, ffn = kind
    dt = L._dtype(cfg)
    ks = rng.split(key, 6)
    params: Params = {"mixer_norm": L.rmsnorm_init(key, cfg.d_model, dt)}
    if mixer == "attn":
        params["attn"] = L.attention_init(ks[..., 0, :], cfg)
    else:
        params["mamba"] = L.mamba_init(ks[..., 0, :], cfg)
    if cross_attention:
        params["cross_norm"] = L.rmsnorm_init(key, cfg.d_model, dt)
        params["cross_attn"] = L.cross_attention_init(ks[..., 1, :], cfg)
    if ffn != "none":
        params["ffn_norm"] = L.rmsnorm_init(key, cfg.d_model, dt)
        if ffn in ("moe", "moe+dense"):
            params["moe"] = L.moe_init(ks[..., 2, :], cfg)
            if ffn == "moe+dense":
                params["dense"] = L.mlp_init(ks[..., 3, :], cfg,
                                             cfg.dense_residual_d_ff)
        else:
            params["mlp"] = L.mlp_init(ks[..., 2, :], cfg, cfg.d_ff)
    return params


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: Kind, *,
                mode: str = "train", cache: Optional[Dict] = None,
                enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                window: int = 0, bidirectional: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, new_cache, aux_loss); aux is the MoE's load-balance loss,
    0 without MoE.  A ``moe+dense`` block adds its residual MLP's output to
    the MoE's, both on the same normalised input.  ``bidirectional`` (the
    audio encoder) attends over the whole sequence, RoPE'd at positions
    0..S-1, through the flash kernel with ``causal=False`` and no cache;
    ``enc_kv`` (a decoder block) adds cross-attention to the encoder's
    (K, V) after the mixer."""
    mixer, ffn = kind
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm_apply(p["mixer_norm"], x, cfg.norm_eps)
    if mixer == "attn" and bidirectional:
        b, s, _ = h.shape
        positions = torch.arange(s, device=h.device)[None].expand(b, s)
        q, k, v = L._qkv(p["attn"], h, cfg, positions)
        att = gqa_flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=False, window=0)
        mix, new_cache = L._out(att, p["attn"]["wo"]), None
    elif mixer == "attn":
        mix, new_cache = L.attention_apply(
            p["attn"], h, cfg, mode=mode, cache=cache, window=window)
    else:
        mix, new_cache = L.mamba_apply(p["mamba"], h, cfg, mode=mode,
                                       cache=cache)
    x = x + mix
    if enc_kv is not None:
        hc = L.rmsnorm_apply(p["cross_norm"], x, cfg.norm_eps)
        x = x + L.cross_attention_apply(p["cross_attn"], hc, enc_kv, cfg)
    if ffn != "none":
        h2 = L.rmsnorm_apply(p["ffn_norm"], x, cfg.norm_eps)
        if ffn in ("moe", "moe+dense"):
            mo, aux = L.moe_apply(p["moe"], h2, cfg)
            if ffn == "moe+dense":
                mo = mo + L.mlp_apply(p["dense"], h2, cfg)
            x = x + mo
        else:
            x = x + L.mlp_apply(p["mlp"], h2, cfg)
    return x, new_cache, aux


def block_cache_init(cfg: ModelConfig, kind: Kind, batch: int, max_len: int,
                     device: torch.device) -> Dict:
    if kind[0] == "attn":
        length = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                  else max_len)
        return L.init_kv_cache(cfg, batch, length, device)
    return L.init_ssm_cache(cfg, batch, device)


def block_cache_specs(kind: Kind) -> Dict:
    """The logical axes of a block's cache (:func:`block_cache_init`)."""
    return L.kv_cache_specs() if kind[0] == "attn" else L.ssm_cache_specs()


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------

def _pattern_period(kinds: List[Kind]) -> int:
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and kinds == kinds[:p] * (n // p):
            return p
    return n


def stack_plan(cfg: ModelConfig) -> Tuple[List[Kind], int, int]:
    """(period_kinds, period, num_repeats) of the reference's layout: with
    ``scan_layers`` its params hold ``period`` block trees, each leaf stacked
    on a leading axis of ``num_repeats``; layer ``r * period + j`` is
    repeat r of block j."""
    kinds = cfg.layer_kinds()
    if not cfg.scan_layers:
        return kinds, len(kinds), 1
    p = _pattern_period(kinds)
    return kinds[:p], p, len(kinds) // p


def stack_init(key: torch.Tensor, cfg: ModelConfig) -> Params:
    """{"blocks": [block params of layer 0, 1, ...]}, layer ``r * period +
    j`` drawn from ``split(split(key, reps)[r], period)[j]`` (``split(key,
    period)[j]`` when the reference does not stack repeats), the
    reference's tree."""
    kinds, period, reps = stack_plan(cfg)
    supers = rng.split(key, reps) if reps > 1 else key[..., None, :]
    blocks = []
    for r in range(reps):
        ks = rng.split(supers[..., r, :], period)
        blocks += [block_init(ks[..., j, :], cfg, kind)
                   for j, kind in enumerate(kinds)]
    return {"blocks": blocks}


# The products that ``remat_policy="dots"`` saves, as the reference's
# ``dots_with_no_batch_dims_saveable`` saves dot_generals without batch
# dimensions: torch folds a (B, S, D) @ (D, F) projection or MLP product into
# one 2-D ``mm`` (``addmm`` with a bias).  Everything else is recomputed
# in the backward: the kernels' ops (``flash_attention``, ``ssd_scan``), the
# MoE's expert products (``bmm``, the expert a batch dimension), norms, RoPE.
DOTS_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _superblock(blocks: List[Params], x: torch.Tensor, cfg: ModelConfig,
                kinds: List[Kind], window: int):
    """The blocks over x -> (x, each block's aux loss)."""
    auxes = []
    for bp, kind in zip(blocks, kinds):
        x, _, a = block_apply(bp, x, cfg, kind, mode="train", window=window)
        auxes.append(a)
    return (x, *auxes)


def stack_apply_train(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/scoring forward through all blocks -> (x, aux_total).

    With ``cfg.remat`` and more than one repeat of ``stack_plan``'s
    superblock, each superblock runs under ``torch.utils.checkpoint``
    (non-reentrant, for ``torch.autograd.grad``; the forward draws no random
    numbers), as the reference wraps its scan body in ``jax.checkpoint``:
    ``remat_policy="dots"`` saves the products of :data:`DOTS_SAVED_OPS`,
    any other policy only the superblock's input, and the backward runs the
    rest again, the kernels included.  The values are the same bits either
    way: the aux losses are summed a layer at a time in both.  torch.func's
    ``grad`` and ``vjp`` refuse the checkpoint's saved-tensor hooks, so a
    config that rematerialises is differentiated with ``torch.autograd``
    (the train step); the FL workloads' configs turn remat off."""
    kinds, period, reps = stack_plan(cfg)
    body = _superblock
    if cfg.remat and reps > 1:
        body = functools.partial(
            checkpoint, _superblock, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=(functools.partial(create_selective_checkpoint_contexts,
                                          _dots_policy)
                        if cfg.remat_policy == "dots" else noop_context_fn))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(reps):
        x, *auxes = body(params["blocks"][r * period:(r + 1) * period], x,
                         cfg, kinds, window)
        for a in auxes:
            aux = aux + a
    return x, aux


def stack_caches_init(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> List[Dict]:
    return [block_cache_init(cfg, kind, batch, max_len, device)
            for kind in cfg.layer_kinds()]


def stack_cache_specs(cfg: ModelConfig) -> List[Dict]:
    """The logical axes of :func:`stack_caches_init`'s caches, a list a
    layer.  The reference's stacked caches carry a leading repeat axis
    (logical ``None``); the port's per-layer list has none."""
    return [block_cache_specs(kind) for kind in cfg.layer_kinds()]


def stack_apply_cached(params: Params, x: torch.Tensor, cfg: ModelConfig,
                       caches: List[Dict], mode: str, window: int = 0
                       ) -> Tuple[torch.Tensor, List[Dict]]:
    new_caches = []
    for bp, kind, cache in zip(params["blocks"], cfg.layer_kinds(), caches):
        x, nc, _ = block_apply(bp, x, cfg, kind, mode=mode, cache=cache,
                               window=window)
        new_caches.append(nc)
    return x, new_caches


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def init_model(key: "rng.KeyLike | None", cfg: ModelConfig,
               device: "str | torch.device | None" = None) -> Params:
    """The reference's random weights for ``key`` (``PRNGKey(0)`` when
    None) on ``device``: ``split(key, 6)``, the embedding from slot 0 and
    the stack from slot 1; a VLM's projector ``w1`` (vision_embed_dim, d)
    and ``w2`` (d, d) from slots 2 and 3; an encoder-decoder's encoder
    block i from ``split(ks[4], encoder_layers + 1)[i]`` and its decoder
    (with cross-attention, in place of the stack) block i from
    ``split(ks[5], num_layers)[i]``.  A batch of keys (…, 2) gives a batch
    of models, every leaf (…, *shape).  Returns the params alone; the
    reference also returns sharding specs."""
    device = resolve_device(device)
    key = rng.as_key(rng.PRNGKey(0) if key is None else key).to(device)
    ks = rng.split(key, 6)
    dt = L._dtype(cfg)
    params: Params = {"embed": L.embed_init(ks[..., 0, :], cfg)}
    if cfg.is_encoder_decoder:
        # The reference draws the plain stack from slot 1 and then replaces
        # it; the port draws only what it keeps.
        eks = rng.split(ks[..., 4, :], cfg.encoder_layers + 1)
        dks = rng.split(ks[..., 5, :], cfg.num_layers)
        params["encoder"] = {"blocks": [
            block_init(eks[..., i, :], cfg, ENC_DEC_KIND)
            for i in range(cfg.encoder_layers)]}
        params["stack"] = {"blocks": [
            block_init(dks[..., i, :], cfg, ENC_DEC_KIND, cross_attention=True)
            for i in range(cfg.num_layers)]}
    else:
        params["stack"] = stack_init(ks[..., 1, :], cfg)
    params["final_norm"] = L.rmsnorm_init(key, cfg.d_model, dt)
    if cfg.arch_type == "vlm":
        params["projector"] = {
            "w1": L.dense_init(ks[..., 2, :],
                               (cfg.vision_embed_dim, cfg.d_model), dt),
            "w2": L.dense_init(ks[..., 3, :], (cfg.d_model, cfg.d_model), dt)}
    return params


def flatten_params(params: Params, prefix: str = "") -> Dict[str, Any]:
    """Nested LM params -> one flat dict keyed by dotted paths, a layer's
    leaves under ``stack.blocks.<layer>.`` (an encoder layer's under
    ``encoder.blocks.<layer>.``; the FL engines' and the optimizers' flat
    form)."""
    out: Dict[str, Any] = {}
    items = (enumerate(params) if isinstance(params, list)
             else params.items())
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list)):
            out.update(flatten_params(value, path + "."))
        else:
            out[path] = value
    return out


def unflatten_params(flat: Dict[str, Any]) -> Params:
    """:func:`flatten_params` undone: ``stack.blocks`` (and
    ``encoder.blocks``) become the per-layer lists again."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, name = path.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def encode_audio(params: Params, frames: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The audio encoder: frame embeddings (B, F, d), cast to the model's
    dtype, through the encoder blocks with bidirectional attention (no
    final norm, as the reference) -> (B, F, d)."""
    x = frames.to(L._dtype(cfg))
    for bp in params["encoder"]["blocks"]:
        x, _, _ = block_apply(bp, x, cfg, ENC_DEC_KIND, mode="train",
                              bidirectional=True)
    return x


def _embed_inputs(params: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Input pathway -> (B, S, d) hidden sequence: the tokens' embeddings,
    after a VLM's projected patches (``patch_embeds`` cast to the
    embedding's dtype, then ``gelu(pe @ w1) @ w2``, tanh gelu as
    ``jax.nn.gelu``'s default)."""
    x = L.embed_apply(params["embed"], batch["tokens"])
    if cfg.arch_type == "vlm":
        proj = params["projector"]
        pe = batch["patch_embeds"].to(x.dtype)
        h = F.gelu(pe @ proj["w1"], approximate="tanh") @ proj["w2"]
        x = torch.cat([h, x], dim=1)
    return x


def _decoder_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   enc: torch.Tensor, mode: str,
                   caches: Optional[List[Dict]] = None
                   ) -> Tuple[torch.Tensor, List[Dict], List[Dict]]:
    """The encoder-decoder's decoder blocks over x with the encoder output
    ``enc``: each block's cross K/V from ``encode_cross_kv`` -> (x, the
    blocks' self caches, their cross K/V as caches)."""
    new_self, cross = [], []
    for i, bp in enumerate(params["stack"]["blocks"]):
        kv = L.encode_cross_kv(bp["cross_attn"], enc, cfg)
        x, nc, _ = block_apply(bp, x, cfg, ENC_DEC_KIND, mode=mode,
                               cache=None if caches is None else caches[i],
                               enc_kv=kv, window=cfg.sliding_window)
        new_self.append(nc)
        cross.append({"k": kv[0], "v": kv[1]})
    return x, new_self, cross


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (training/scoring) -> (logits, aux).  A VLM's
    logits cover its patches and then its text."""
    x = _embed_inputs(params, cfg, batch)
    if cfg.is_encoder_decoder:
        enc = encode_audio(params, batch["frames"], cfg)
        x, _, _ = _decoder_apply(params, x, cfg, enc, "train")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = stack_apply_train(params["stack"], x, cfg,
                                   window=cfg.sliding_window)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return L.unembed_apply(params["embed"], x), aux


def token_ce(logits: torch.Tensor, targets: torch.Tensor, *,
             with_accuracy: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked next-token CE over full-sequence logits (-1 = ignore id) ->
    (loss, {"ntok"[, "accuracy"]}), as the reference defines it."""
    logits = logits.float()
    valid = targets >= 0
    tsafe = torch.where(valid, targets, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tsafe[..., None].long())[..., 0]
    nll = (logz - gold) * valid
    denom = torch.clamp(valid.sum(), min=1)
    loss = nll.sum() / denom
    m: Dict[str, torch.Tensor] = {"ntok": denom}
    if with_accuracy:
        m["accuracy"] = ((logits.argmax(-1) == tsafe) * valid).sum() / denom
    return loss, m


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over ``batch["targets"]`` (−1 = ignore) plus the MoE
    aux loss (0 without MoE) -> (total, {"ce", "aux", "ntok"}).  A VLM
    scores its text positions only, the last T of its logits."""
    logits, aux = forward(params, cfg, batch)
    targets = batch["targets"]
    if cfg.arch_type == "vlm":
        logits = logits[:, -targets.shape[1]:]
    loss, m = token_ce(logits, targets)
    total = loss + cfg.router_aux_weight * aux
    return total, {"ce": loss, "aux": aux, "ntok": m["ntok"]}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: "str | torch.device | None" = None):
    """One cache per layer: K/V (B, max_len or window, KV, hd) for attention,
    the conv tail and the (H, P, N) state for Mamba.  An encoder-decoder's
    are ``{"self": [...], "cross": [...]}``, a decoder layer's cross cache
    the encoder's K/V, (B, num_frames, KV, hd) each, zeros here."""
    device = resolve_device(device)
    caches = stack_caches_init(cfg, batch, max_len, device)
    if not cfg.is_encoder_decoder:
        return caches
    shape = (batch, cfg.num_frames, cfg.num_kv_heads, cfg.resolved_head_dim)
    cross = [{"k": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
              "v": torch.zeros(shape, dtype=L._dtype(cfg), device=device)}
             for _ in range(cfg.num_layers)]
    return {"self": caches, "cross": cross}


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Run the prompt -> (last-position logits (B, V), caches).  An
    encoder-decoder encodes ``batch["frames"]`` once and its caches' cross
    K/V are each decoder layer's ``encode_cross_kv`` of that output."""
    x = _embed_inputs(params, cfg, batch)
    if cfg.is_encoder_decoder:
        caches = stack_caches_init(cfg, x.shape[0], max_len, x.device)
        enc = encode_audio(params, batch["frames"], cfg)
        x, new_self, cross = _decoder_apply(params, x, cfg, enc, "prefill",
                                            caches)
        new_caches = {"self": new_self, "cross": cross}
    else:
        caches = init_caches(cfg, x.shape[0], max_len, x.device)
        x, new_caches = stack_apply_cached(params["stack"], x, cfg, caches,
                                           mode="prefill",
                                           window=cfg.sliding_window)
    x = L.rmsnorm_apply(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.unembed_apply(params["embed"], x)[:, 0], new_caches


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                caches):
    """One decode step: tokens (B,) -> (logits (B, V), caches).  The caches'
    tensors are updated in place; an encoder-decoder reads its cross K/V
    back from ``caches["cross"]``."""
    x = L.embed_apply(params["embed"], tokens[:, None])
    if cfg.is_encoder_decoder:
        new_self = []
        for bp, cache, cross in zip(params["stack"]["blocks"],
                                    caches["self"], caches["cross"]):
            x, nc, _ = block_apply(bp, x, cfg, ENC_DEC_KIND, mode="decode",
                                   cache=cache,
                                   enc_kv=(cross["k"], cross["v"]),
                                   window=cfg.sliding_window)
            new_self.append(nc)
        new_caches = {"self": new_self, "cross": caches["cross"]}
    else:
        x, new_caches = stack_apply_cached(params["stack"], x, cfg, caches,
                                           mode="decode",
                                           window=cfg.sliding_window)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return L.unembed_apply(params["embed"], x)[:, 0], new_caches


__all__ = ["block_apply", "block_cache_init", "block_cache_specs",
           "block_init", "decode_step", "encode_audio",
           "flatten_params", "forward", "init_caches", "init_model",
           "loss_fn", "prefill", "stack_apply_cached", "stack_apply_train",
           "stack_cache_specs", "stack_init", "stack_plan", "token_ce",
           "unflatten_params"]
