"""Shared checks of the port's LM stack against the JAX reference on the
CPU, one arch at a time (tests/test_torch_moe.py,
tests/test_torch_arch_zoo.py and tests/test_torch_vlm_audio.py parametrise
them over their archs).  A VLM's batches also carry NumPy-made
``patch_embeds`` and an encoder-decoder's ``frames`` (``extras``).

The conventions are tests/test_torch_lm.py's: both stacks get the same
NumPy-made weights (the reference init's tree with every leaf redrawn from
a seed) and the same NumPy-made tokens at ``reduced(dtype="float32")``,
where the port's kernel wrappers take their plain versions.  The reference's
calls are jitted (``jax.jit`` with the config static), which keeps its
compile time off the op-by-op path; nothing in ``src/repro`` changes.

Tolerances, each the one the file it comes from states:

* logits, hidden states and caches within ``TOL`` = 2e-4
  (tests/test_torch_lm.py: float32 sums in other orders, the chunked SSD
  against the sequential recurrence); cache ``idx`` equal;
* ``token_ce`` within 1e-5, its accuracy within 1e-6;
* ``loss_fn`` (with the MoE aux loss) within ``LOSS_RTOL`` = 1e-5 relative,
  each gradient leaf within ``GRAD_TOL`` = 1e-4 of its largest magnitude
  (tests/test_torch_train.py);
* keyed ``init_model``: normals within ``INIT_ULP`` = 3 ulps, Mamba's
  ``A_log`` within 1 (tests/test_torch_train.py);
* bf16, the whole model: prefill and 8 decode steps within 2e-2 of the
  step's largest |logit|, the reference's own bf16 pin for decode ≡
  forward
  (tests/test_torch_lm.py::test_bf16_prefill_and_decode_match_at_the_reference_pin);
* bf16, one layer of each kind on the same bf16 input: within one bf16 ulp
  of the layer's largest |output| (2^-7 of it), the size of the reference's
  own jit-against-eager gap (scripts/torch_bf16_lm_gap.py);
* converter round trips and config fields: equal.
"""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_model as jinit_model
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.models import token_ce as jtoken_ce

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch import roofline, steps
from repro_torch.models import (decode_step, forward, init_model, loss_fn,
                                prefill, token_ce)
from repro_torch.models.transformer import unflatten_params

TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
INIT_ULP = 3


def t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def close(port, ref, tol=TOL):
    if torch.is_tensor(port):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


def close_caches(port, ref):
    """Per-layer caches; an encoder-decoder's ``{"self", "cross"}`` pair
    of them."""
    if isinstance(port, dict):
        assert set(port) == set(ref) == {"self", "cross"}
        for part in ("self", "cross"):
            close_caches(port[part], ref[part])
        return
    assert len(port) == len(ref)
    for pc, rc in zip(port, ref):
        assert set(pc) == set(rc)
        for key in pc:
            if key == "idx":
                assert pc[key] == int(rc[key])
            else:
                close(pc[key], rc[key])


def cfgs(arch, **over):
    over = {"dtype": "float32", **over}
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


def np_tree(tree, seed):
    """Every leaf redrawn around its init: value + 0.3·std·N(0, 1), with std
    the leaf's own spread (0.1 for a constant leaf)."""
    g = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a, np.float32)
        std = float(a.std()) or 0.1
        return (a + 0.3 * std * g.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(redraw, tree)


@functools.lru_cache(maxsize=None)
def _jinit(jcfg):
    return jax.jit(lambda k: jinit_model(k, jcfg)[0])


def models(arch, seed=0, **over):
    """(jcfg, tcfg, reference params, port params) on the same redrawn
    weights."""
    jcfg, tcfg = cfgs(arch, **over)
    tree = np_tree(_jinit(jcfg)(jax.random.PRNGKey(seed)), seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, lm_params_from_jax(tree, tcfg, device="cpu")


def tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def extras(cfg, b, seed=0):
    """The stub frontends' inputs of a batch of ``b``, NumPy normals from
    ``seed``: a VLM's ``patch_embeds`` (b, num_patch_tokens,
    vision_embed_dim) and an encoder-decoder's ``frames`` (b, num_frames,
    d_model), float32; none for the text archs."""
    g = np.random.default_rng(seed + 1000)
    out = {}
    if cfg.arch_type == "vlm":
        out["patch_embeds"] = g.standard_normal(
            (b, cfg.num_patch_tokens, cfg.vision_embed_dim)).astype(
                np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = g.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return out


def batches(cfg, np_batch):
    """(reference batch, port batch) of one NumPy batch: int32 token ids
    and float32 embeddings on the reference's side; on the port's the ids
    as int64, the embeddings float32."""
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    tb = {k: t(v).long() if v.dtype == np.int32 else t(v)
          for k, v in np_batch.items()}
    return jb, tb


def patches(cfg):
    """Positions a VLM's patches take before its text."""
    return cfg.num_patch_tokens if cfg.arch_type == "vlm" else 0


# The reference's entry points, jitted with the config (and max_len) static.
_jprefill = jax.jit(jprefill, static_argnums=(1, 3))
_jdecode = jax.jit(jdecode_step, static_argnums=(1,))
_jforward = jax.jit(jforward, static_argnums=(1,))


def check_configs(arch):
    """Full and reduced configs field for field, and their layer kinds."""
    full_j, full_t = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert full_t.layer_kinds() == full_j.layer_kinds()
    for over in ({}, {"dtype": "float32"}, {"vocab_size": 512}):
        red_j, red_t = full_j.reduced(**over), full_t.reduced(**over)
        assert dataclasses.asdict(red_t) == dataclasses.asdict(red_j)
        assert red_t.layer_kinds() == red_j.layer_kinds()


def check_prefill_and_decode(arch, gen=8, **over):
    """Prefill of a 37-token prompt (no multiple of the SSD chunk, 32), then
    ``gen`` decode steps: logits and caches at every step (an
    encoder-decoder's cross caches too).  ``over`` changes the reduced
    config."""
    jcfg, tcfg, jp, tp = models(arch, **over)
    b, prompt = 2, 37
    toks = tokens(b, prompt + gen, jcfg.vocab_size, seed=4)
    max_len = prompt + gen + patches(jcfg)
    jb, tb = batches(jcfg, {"tokens": toks[:, :prompt],
                            **extras(jcfg, b, seed=4)})
    last_t, caches_t = prefill(tp, tcfg, tb, max_len)
    last_j, caches_j = _jprefill(jp, jcfg, jb, max_len)
    close(last_t, last_j)
    close_caches(caches_t, caches_j)
    for i in range(prompt, prompt + gen):
        logits_t, caches_t = decode_step(tp, tcfg, t(toks[:, i]), caches_t)
        logits_j, caches_j = _jdecode(jp, jcfg, jnp.asarray(toks[:, i]),
                                      caches_j)
        close(logits_t, logits_j)
        close_caches(caches_t, caches_j)


def check_forward_and_token_ce(arch, scan_layers, **over):
    """``forward`` (logits and the summed aux) and ``token_ce`` at 3
    layers (a VLM's logits cover its patches, then its text)."""
    jcfg, tcfg, jp, tp = models(arch, seed=5, scan_layers=scan_layers,
                                num_layers=3, **over)
    toks = tokens(2, 20, jcfg.vocab_size, seed=5)
    jb, tb = batches(jcfg, {"tokens": toks, **extras(jcfg, 2, seed=5)})
    logits_t, aux_t = forward(tp, tcfg, tb)
    logits_j, aux_j = _jforward(jp, jcfg, jb)
    assert logits_t.shape[1] == 20 + patches(jcfg)
    close(logits_t, logits_j)
    close(aux_t, aux_j, 1e-5)
    if tcfg.num_experts == 0:
        assert float(aux_t) == float(aux_j) == 0.0
    else:
        assert float(aux_t) > 0
    targets = np.roll(toks, -1, axis=1)
    targets[:, -1] = -1
    text = slice(patches(jcfg), None)
    loss_t, m_t = token_ce(logits_t[:, text], t(targets), with_accuracy=True)
    loss_j, m_j = jtoken_ce(logits_j[:, text], jnp.asarray(targets),
                            with_accuracy=True)
    close(loss_t, loss_j, 1e-5)
    assert int(m_t["ntok"]) == int(m_j["ntok"])
    close(m_t["accuracy"], m_j["accuracy"], 1e-6)


def _leafwise_close(port_tree, ref_tree, tol):
    worst = 0.0
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(ref_tree),
            jax.tree_util.tree_leaves(port_tree)):
        want = np.asarray(want)
        scale = float(np.abs(want).max()) or 1.0
        gap = float(np.abs(np.asarray(got) - want).max()) / scale
        assert gap <= tol, (jax.tree_util.keystr(path), gap)
        worst = max(worst, gap)
    return worst


def check_loss_and_grads(arch, **over):
    """``loss_fn`` (CE plus ``router_aux_weight`` · aux; a VLM scoring its
    text only) and its gradients on a batch of 2 × 45 tokens with an
    ignored target."""
    jcfg, tcfg = cfgs(arch, **over)
    tree = np_tree(_jinit(jcfg)(jax.random.PRNGKey(6)), 6)
    toks = tokens(2, 45, jcfg.vocab_size, seed=6)
    targets = np.roll(toks, -1, axis=1)
    targets[:, -1] = -1
    targets[0, 3] = -1
    jb, tb = batches(jcfg, {"tokens": toks, "targets": targets,
                            **extras(jcfg, 2, seed=6)})

    def jl(p):
        total, m = jloss_fn(p, jcfg, jb)
        return total, m["aux"]

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    flat = lm_params_from_jax(tree, tcfg, device="cpu", flat=True)

    def tl(p):
        total, m = loss_fn(unflatten_params(p), tcfg, tb)
        return total, m["aux"]

    tgrads, (tloss, taux) = torch.func.grad_and_value(tl, has_aux=True)(flat)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    close(taux, jaux, 1e-5)
    if tcfg.num_experts:
        assert float(jaux) > 0
    return _leafwise_close(lm_params_to_jax(tgrads, tcfg), jgrads, GRAD_TOL)


def ulps(a, b):
    def order(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(order(a) - order(b))


def check_init_model(arch, scan_layers):
    """Keyed ``init_model`` of the reduced arch at 3 layers against the
    reference's jitted init, leaf by leaf in ulps."""
    jcfg, tcfg = cfgs(arch, num_layers=3, scan_layers=scan_layers,
                      d_model=64, vocab_size=128)
    ref = _jinit(jcfg)(jax.random.PRNGKey(5))
    port = lm_params_to_jax(init_model(rng.PRNGKey(5), tcfg, device="cpu"),
                            tcfg)
    assert (jax.tree_util.tree_structure(port)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                np.asarray, ref)))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(ref),
                                 jax.tree_util.tree_leaves(port)):
        assert got.dtype == np.asarray(want).dtype, jax.tree_util.keystr(path)
        limit = 1 if "A_log" in jax.tree_util.keystr(path) else INIT_ULP
        assert ulps(got, want).max() <= limit, jax.tree_util.keystr(path)


def layout_tree(jcfg, seed):
    """A tree of the reference's ``init_model`` layout for ``jcfg`` (its
    structure, shapes and dtypes from ``jax.eval_shape``, nothing
    compiled), every leaf NumPy normals from ``seed``: the converter's
    checks are about where each leaf goes, not its values."""
    g = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jinit_model(k, jcfg)[0],
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda a: g.standard_normal(a.shape).astype(a.dtype), shapes)


def check_converter_round_trip(arch, scan_layers, **over):
    """The reference's tree -> the port's per-layer list (layer r·period + j
    = repeat r of block j) -> the reference's tree, bit-equal."""
    jcfg, tcfg = cfgs(arch, scan_layers=scan_layers, **over)
    tree = layout_tree(jcfg, seed=7)
    port = lm_params_from_jax(tree, tcfg, device="cpu")
    blocks = port["stack"]["blocks"]
    assert isinstance(blocks, list) and len(blocks) == tcfg.num_layers
    _, period, reps = jsteps_plan(jcfg)
    if jcfg.is_encoder_decoder:    # the decoder is unrolled in any case
        period, reps = jcfg.num_layers, 1
    ref_blocks = tree["stack"]["blocks"]
    for i, block in enumerate(blocks):
        r, j = divmod(i, period)
        ref = (jax.tree_util.tree_map(lambda a: a[r], ref_blocks[j])
               if reps > 1 else ref_blocks[i])
        assert set(block) == set(ref)
        for got, want in zip(jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda x: x.numpy(), block)),
                jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(got, want)
    back = lm_params_to_jax(port, tcfg)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    return period, reps


def jsteps_plan(jcfg):
    from repro.models.transformer import stack_plan as jstack_plan
    return jstack_plan(jcfg)


def check_bf16_pin(arch):
    """Both stacks at ``reduced()`` in bf16 from the same redrawn weights
    (cast to bf16 on the reference's side; a MoE router stays float32, as
    ``moe_init`` makes it): prefill of a 37-token prompt and 8 decode
    steps, each within 2e-2 of the step's largest |logit|."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    tree = np_tree(_jinit(jcfg)(jax.random.PRNGKey(9)), 9)
    ref_dtypes = jax.tree_util.tree_map(lambda a: a.dtype,
                                        _jinit(jcfg)(jax.random.PRNGKey(9)))
    tree = jax.tree_util.tree_map(lambda a, dt: a.astype(dt), tree,
                                  ref_dtypes)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = lm_params_from_jax(tree, tcfg, device="cpu")
    b, prompt, gen = 2, 37, 8
    toks = tokens(b, prompt + gen, jcfg.vocab_size, seed=10)
    max_len = prompt + gen + patches(jcfg)
    jb, tb = batches(jcfg, {"tokens": toks[:, :prompt],
                            **extras(jcfg, b, seed=10)})
    last_t, caches_t = prefill(tp, tcfg, tb, max_len)
    last_j, caches_j = _jprefill(jp, jcfg, jb, max_len)

    def pin(port, ref):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(port.float().numpy(), ref, rtol=0,
                                   atol=2e-2 * np.abs(ref).max())

    pin(last_t, last_j)
    for i in range(prompt, prompt + gen):
        logits_t, caches_t = decode_step(tp, tcfg, t(toks[:, i]), caches_t)
        logits_j, caches_j = _jdecode(jp, jcfg, jnp.asarray(toks[:, i]),
                                      caches_j)
        pin(logits_t, logits_j)


def bf16_layer_cases(arch):
    """(name, reference init, reference apply, port apply) of each layer
    kind ``arch`` stacks, on (B, S, d) inputs."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    kinds = {k for kind in tcfg.layer_kinds() for k in kind}
    cases = []
    if "attn" in kinds:
        cases.append(("attn", JL.attention_init,
                      lambda p, x: JL.attention_apply(p, x, jcfg)[0],
                      lambda p, x: TL.attention_apply(p, x, tcfg)[0]))
    if "mamba" in kinds:
        cases.append(("mamba", JL.mamba_init,
                      lambda p, x: JL.mamba_apply(p, x, jcfg)[0],
                      lambda p, x: TL.mamba_apply(p, x, tcfg)[0]))
    if "dense" in kinds:
        cases.append(("mlp", lambda k, c: JL.mlp_init(k, c, c.d_ff),
                      lambda p, x: JL.mlp_apply(p, x, jcfg),
                      lambda p, x: TL.mlp_apply(p, x, tcfg)))
    if kinds & {"moe", "moe+dense"}:
        cases.append(("moe", JL.moe_init,
                      lambda p, x: JL.moe_apply(p, x, jcfg)[0],
                      lambda p, x: TL.moe_apply(p, x, tcfg)[0]))
    return jcfg, cases


def check_bf16_layers(arch, seed=1):
    """Each layer kind of ``arch`` at ``reduced()`` in bf16, on the same
    bf16 input (2, 37, d) and redrawn weights (a router stays float32):
    the port's output within one bf16 ulp of the largest |output| of the
    reference's jitted layer, 2^-7 of it.  Returns {kind: (gap, scale)}."""
    from repro_torch.convert import _leaf_to_torch
    jcfg, cases = bf16_layer_cases(arch)
    x = np.random.default_rng(seed).standard_normal(
        (2, 37, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    out = {}
    for name, init, japply, tapply in cases:
        tree0 = init(jax.random.PRNGKey(seed), jcfg)[0]
        tree = jax.tree_util.tree_map(lambda a, r: a.astype(r.dtype),
                                      np_tree(tree0, seed), tree0)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        tp = {k: _leaf_to_torch(np.asarray(v), torch.device("cpu"))
              for k, v in tree.items()}
        want = np.asarray(jax.jit(japply)(jp, xj), np.float32)
        got = tapply(tp, xt)
        assert got.dtype == torch.bfloat16, name
        gap = float(np.abs(got.float().numpy() - want).max())
        scale = float(np.abs(want).max())
        assert gap <= 2.0 ** -7 * scale, (name, gap, scale)
        out[name] = (gap, scale)
    return out


def check_param_counts(arch):
    """``param_count`` (over ``meta`` tensors) and ``active_param_count`` of
    the full config equal the reference's (over ``jax.eval_shape``)."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    n = jsteps.param_count(jcfg)
    assert steps.param_count(tcfg) == n
    assert roofline.active_param_count(tcfg) == \
        jroofline.active_param_count(jcfg)
    return n
