"""Parity of the port's VLM and audio pathways with the JAX reference on the
CPU: phi-3-vision-4.2b (a projector of stub patch embeddings, the patches
before the text, text-only scoring; head_dim 96 at full width) and
whisper-tiny (an encoder over stub frame embeddings with bidirectional
attention, decoder blocks that cross-attend to its K/V, ``{"self",
"cross"}`` caches).

The whole-model checks and their tolerances are tests/torch_lm_parity.py's
(2e-4 for logits and caches, cross caches included; ``token_ce`` 1e-5;
``loss_fn`` 1e-5 relative and each gradient leaf 1e-4 of its largest
magnitude; keyed init within 3 ulps; the converter, checkpoints and configs
equal; bf16 prefill and 8 decode steps within 2e-2 of the step's largest
|logit|), their batches carrying NumPy-made ``patch_embeds`` and
``frames``.  ``reduced()`` forces head_dim 64, so phi-3-vision is also held
at ``reduced(head_dim=96)``, there also through one ``make_train_step`` step
against the reference's (the loss within 1e-5 relative, the parameters
within 1e-3 of the update, as tests/test_torch_train.py holds qwen3-14b's).

The encoder's attention is the flash wrapper with ``causal=False`` (on a
CPU tensor its plain version), held at 2e-4 to the function the
reference's encoder computes, ``layers._sdpa(q, k, v, None, ...)``, at
whisper's 1500 frames.  The reference's Pallas kernel is held only at
S = 256: see ``test_noncausal_attention_matches_the_pallas_kernel_at_256``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jax.sharding import AxisType  # noqa: E402

from repro import sharding as jsh  # noqa: E402
from repro.ckpt import load_checkpoint as jload_checkpoint  # noqa: E402
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention as jflash)
from repro.launch import steps as jsteps  # noqa: E402
from repro.configs.shapes import InputShape as JInputShape  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim import OptState as JOptState  # noqa: E402

import torch_lm_parity as P  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.ckpt import (load_checkpoint, read_checkpoint,  # noqa: E402
                              save_checkpoint)
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402,E501
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 gqa_flash_attention)
from repro_torch.kernels.flash_attention.backward import launch_backward  # noqa: E402,E501
from repro_torch.launch import dryrun, roofline, steps  # noqa: E402
from repro_torch.launch.serve import run_serve  # noqa: E402
from repro_torch.launch.train import run_train  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.transformer import flatten_params  # noqa: E402

ARCHS = ("phi-3-vision-4.2b", "whisper-tiny")
# phi-3-vision's head_dim at full width (3072 / 32), which reduced() drops.
HD96 = {"head_dim": 96}
# One train step against the reference's, as tests/test_torch_train.py.
LOSS_RTOL = 1e-5
STEP_REL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: the tensors are small, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_registry_and_the_published_widths():
    vlm, audio = get_config("phi-3-vision-4.2b"), get_config("whisper-tiny")
    assert (vlm.arch_type, vlm.resolved_head_dim, vlm.num_kv_heads,
            vlm.num_patch_tokens, vlm.vision_embed_dim) == (
                "vlm", 96, 32, 1024, 1024)
    assert (audio.is_encoder_decoder, audio.encoder_layers, audio.num_layers,
            audio.num_frames, audio.resolved_head_dim) == (
                True, 4, 4, 1500, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    P.check_configs(arch)


@pytest.mark.parametrize("arch,scan_layers", [
    ("phi-3-vision-4.2b", False), ("phi-3-vision-4.2b", True),
    ("whisper-tiny", False)])
def test_init_model_matches_reference(arch, scan_layers):
    """The keyed tree: a VLM's projector from slots 2 and 3; the encoder
    from ``split(ks[4], L + 1)``, the cross-attending decoder from
    ``split(ks[5], L)``.  The reference unrolls whisper whatever
    ``scan_layers`` says, so one layout of it is held."""
    P.check_init_model(arch, scan_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_token_ce_match(arch):
    P.check_forward_and_token_ce(arch, scan_layers=False)


# Each arch at reduced(), and phi-3-vision at reduced(head_dim=96): its
# prefill runs the whole forward of the prompt at head_dim 96.
CASES = [(arch, {}) for arch in ARCHS] + [("phi-3-vision-4.2b", HD96)]
CASE_IDS = [f"{arch}-hd{over.get('head_dim', 64)}" for arch, over in CASES]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_gradients_match(arch):
    """The VLM scores its text only; whisper's gradients reach the encoder
    through the non-causal attention and cross-attention."""
    P.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch,over", CASES, ids=CASE_IDS)
def test_prefill_and_every_decode_step_match(arch, over):
    P.check_prefill_and_decode(arch, gen=8, **over)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_lm_converter_round_trip(arch, scan_layers):
    P.check_converter_round_trip(arch, scan_layers, num_layers=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_both_ways(tmp_path, arch, dtype):
    """The port's tree saved and loaded bit-equal (``encoder.blocks/<i>``,
    ``projector``), and read by the reference's loader through
    ``lm_params_to_jax`` bit-equal."""
    jcfg, cfg = P.cfgs(arch, dtype=dtype)
    params = init_model(None, cfg, device="cpu")
    tmpl = steps.abstract_params(cfg)
    path = save_checkpoint(str(tmp_path / "port"), 3, params)
    got, meta = load_checkpoint(path, tmpl, device="cpu")
    assert meta["step"] == 3
    flat_got, flat_want = flatten_params(got), flatten_params(params)
    assert list(flat_got) == list(flat_want)
    assert any(k.startswith("encoder.blocks.1.") or k.startswith("projector")
               for k in flat_got)
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype and torch.equal(flat_got[k], v), k
    ref_tree = lm_params_to_jax(params, cfg)
    jtmpl = jax.eval_shape(lambda k: P.jinit_model(k, jcfg)[0],
                           jax.random.PRNGKey(0))
    back, _ = jload_checkpoint(path, jtmpl)
    for (kp, want), have in zip(jax.tree_util.tree_leaves_with_path(ref_tree),
                                jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(
            np.asarray(have).view(np.uint8), np.asarray(want).view(np.uint8),
            jax.tree_util.keystr(kp))
    tree, _ = read_checkpoint(path)
    again = lm_params_from_jax(tree, cfg, device="cpu")
    for k, v in flatten_params(again).items():
        assert torch.equal(v, flat_want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_at_the_reference_pin(arch):
    P.check_bf16_pin(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    P.check_param_counts(arch)


def test_cross_attention_layers_match():
    """``encode_cross_kv`` and ``cross_attention_apply`` alone (q from the
    decoder, K/V from 64 frames, biases on), at 2e-4."""
    from repro_torch.models import layers as TL
    jcfg, tcfg = P.cfgs("whisper-tiny", qkv_bias=True)
    tree = P.np_tree(JL.cross_attention_init(jax.random.PRNGKey(3),
                                             jcfg)[0], 3)
    g = np.random.default_rng(3)
    x = g.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    enc = g.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = {k: P.t(v) for k, v in tree.items()}
    jkv = JL.encode_cross_kv(jp, jnp.asarray(enc), jcfg)
    tkv = TL.encode_cross_kv(tp, P.t(enc), tcfg)
    for a, b in zip(tkv, jkv):
        P.close(a, b)
    P.close(TL.cross_attention_apply(tp, P.t(x), tkv, tcfg),
            JL.cross_attention_apply(jp, jnp.asarray(x), jkv, jcfg))


def _qkv(b, s, h, kv, d, seed):
    g = np.random.default_rng(seed)
    q = g.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (g.standard_normal((b, s, kv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def test_noncausal_attention_at_1500_frames_matches_the_encoders_sdpa():
    """whisper's encoder length (11 full 128-row tiles and a 92-row edge)
    at head_dim 64, two heads: the wrapper with ``causal=False``
    against ``_sdpa(q, k, v, None, ...)``, the function the reference's
    encoder computes."""
    q, k, v = _qkv(1, 1500, 2, 2, 64, seed=21)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 2)
    got = gqa_flash_attention(P.t(q), P.t(k), P.t(v), causal=False)
    P.close(got, want)


def test_noncausal_attention_matches_the_pallas_kernel_at_256():
    """The reference's Pallas kernel in interpret mode, ``causal=False``, at
    S = 256 (a multiple of its 128-row block).  Only there: it pads S up to
    its block with zero keys that only the causal mask would hide, so at
    (2, S, 64) float32 it differs from a dense softmax by 0.072 at S = 200
    and 3.0e-3 at S = 1500 (max abs; 4.8e-7 at S = 256), and the
    reference's models never call it there (ROADMAP.md, residual
    differences)."""
    g = np.random.default_rng(8)
    q, k, v = (g.standard_normal((2, 256, 64)).astype(np.float32)
               for _ in range(3))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False, interpret=True)
    got = flash_attention(P.t(q), P.t(k), P.t(v), causal=False)
    P.close(got, want)


def test_backward_takes_the_forwards_head_dims_and_refuses_others():
    """The backward kernels take the forward's head_dims in both dtypes
    (96 for phi-3-vision, 192 for nemotron), so every arch trains on the
    card; any other head_dim raises on the kernels' path before it looks
    at the device, and never gives way to the plain backward."""
    from repro_torch.kernels.flash_attention.backward import BWD_HEAD_DIMS
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
    for dtype in (torch.bfloat16, torch.float32):
        assert BWD_HEAD_DIMS[dtype] == HEAD_DIMS[dtype]
        assert {96, 192} <= set(BWD_HEAD_DIMS[dtype])
    lse = torch.zeros((1, 2, 8), dtype=torch.float32)
    kernels.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros((1, 8, 2, 48), dtype=dtype)
        with pytest.raises(ValueError, match="head_dim in"):
            launch_backward(x, x, x, x, lse, x, causal=True, window=0)
    assert kernels.launch_counts()["flash_attention_bwd"] == 0


def test_train_step_at_head_dim_96_matches_reference():
    """One ``make_train_step`` step of phi-3-vision at
    ``reduced(head_dim=96)`` (loss over the text, clip, AdamW over the flat
    params) against the reference's, jitted on a one-device mesh, on the
    same redrawn weights and batch: the step the card trains with, through
    the attention backward at head_dim 96.  The loss within ``LOSS_RTOL``;
    the parameters' gap within ``STEP_REL`` of the update, as
    tests/test_torch_train.py holds qwen3-14b's steps."""
    jcfg, tcfg = P.cfgs("phi-3-vision-4.2b", **HD96)
    tree = P.np_tree(P._jinit(jcfg)(jax.random.PRNGKey(9)), 9)
    b, text = 2, 24
    toks = P.tokens(b, text, jcfg.vocab_size, seed=9)
    targets = np.roll(toks, -1, axis=1)
    targets[:, -1] = -1
    jb, tb = P.batches(jcfg, {"tokens": toks, "targets": targets,
                              **P.extras(jcfg, b, seed=9)})
    seq = text + P.patches(jcfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fn, in_sh, out_sh, _, rules = jsteps.make_train_step(
        jcfg, mesh, JInputShape("custom", seq, b, "train"), microbatches=1)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    zeros = jax.tree_util.tree_map(
        lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
    state = JOptState(step=jnp.zeros((), jnp.int32), mu=zeros, nu=zeros)
    with mesh, jsh.shard_ctx(mesh, rules):
        jnew, _, jm = jax.jit(fn, in_shardings=in_sh,
                              out_shardings=out_sh)(jparams, state, jb)
    step, opt = steps.make_train_step(
        tcfg, InputShape("custom", seq, b, "train"), 1)
    init = [np.array(x) for x in jax.tree_util.tree_leaves(tree)]
    params = lm_params_from_jax(tree, tcfg, device="cpu")
    new, _, m = step(params, opt.init(flatten_params(params)), tb)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        LOSS_RTOL * abs(float(jm["loss"]))
    got = jax.tree_util.tree_leaves(lm_params_to_jax(new, tcfg))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jnew)]
    gap = np.sqrt(sum(((g - w) ** 2).sum() for g, w in zip(got, want)))
    upd = np.sqrt(sum(((w - i) ** 2).sum() for w, i in zip(want, init)))
    assert gap <= STEP_REL * upd, gap / upd


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_rules_equal_the_reference(arch):
    jcfg, tcfg = P.jget_config(arch), get_config(arch)
    for name, tshape in SHAPES.items():
        jshape = JInputShape(*dataclasses.astuple(tshape))
        assert steps.arch_shape_applicable(tcfg, tshape) == \
            jsteps.arch_shape_applicable(jcfg, jshape)
        assert dataclasses.asdict(steps.config_for_shape(tcfg, tshape)) == \
            dataclasses.asdict(jsteps.config_for_shape(jcfg, jshape))


def test_traced_whisper_prefill_counts_the_encoder_noncausal():
    """The dry-run's trace of a reduced whisper prefill: one flash launch
    an encoder and a decoder layer, the encoder's at F² live pairs (its
    ``causal=False``), the decoder's at S(S+1)/2."""
    cfg = get_config("whisper-tiny").reduced()
    b, s = 2, 24
    step, args = steps.make_prefill_step(cfg, InputShape("p", s, b,
                                                         "prefill"))
    gm = dryrun.trace_step(step, args)
    assert dryrun.kernel_nodes(gm)["flash_attention"] == (
        cfg.encoder_layers + cfg.num_layers)
    h, hd, f = cfg.num_heads, cfg.resolved_head_dim, cfg.num_frames
    want = 4 * b * h * hd * (cfg.encoder_layers * f * f
                             + cfg.num_layers * s * (s + 1) // 2)
    assert roofline.graph_flops(gm)["flash_attention"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_on_the_cpu(arch):
    """``run_serve`` (the VLM's caches hold its patches) and ``run_train``
    with the reference's stub inputs, at reduced size; a prefill step and
    a serve step through ``launch.steps``, one flash launch an attention
    layer (the encoder's included) counted in neither: the CPU takes the
    plain version."""
    seqs, t_prefill, t_decode = run_serve(arch, batch=2, prompt_len=20,
                                          gen=3, device="cpu")
    assert seqs.shape == (2, 3) and int(seqs.max()) < 512
    losses = run_train(arch, steps=2, batch=2, seq=16, reduced=True,
                       device="cpu", log_every=100)
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = get_config(arch).reduced(vocab_size=512)
    seq = 16 + P.patches(cfg)
    kernels.reset_launch_counts()
    pre, (ptmpl, btmpl) = steps.make_prefill_step(
        cfg, InputShape("p", seq, 2, "prefill"))
    params = init_model(None, cfg, device="cpu")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in btmpl.items()}
    toks, caches = pre(params, batch)
    serve, _ = steps.make_serve_step(cfg, InputShape("d", seq, 2, "decode"))
    nxt, caches = serve(params, toks, caches)
    assert nxt.shape == (2,) and nxt.dtype == torch.int32
    assert not any(kernels.launch_counts().values())


def test_dryrun_prefill_32k_outgrows_one_card_for_both_archs():
    """The dry-run at the assigned prefill shape, over fake tensors: each
    arch's attention layers launch the kernel once (whisper's encoder
    included), and neither arch's 32k-token prefill fits one card, the
    verdict following the estimated peak against the card's memory."""
    for arch in ARCHS:
        rec = dryrun.dryrun_one(arch, "prefill_32k", save=False,
                                verbose=False)
        cfg = get_config(arch)
        assert rec["params"] == steps.param_count(cfg)
        assert rec["kernel_launches"]["flash_attention"] == (
            cfg.num_layers + cfg.encoder_layers)
        assert rec["peak_memory_per_device"] > dryrun.HBM_BYTES
        assert rec["fits_one_card"] is False
