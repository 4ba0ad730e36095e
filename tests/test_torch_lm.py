"""Parity of the port's LM serving path (configs, layers, transformer,
TokenDataset, run_serve and the LM weight converter) with the JAX reference
on the CPU.

Both stacks get the same NumPy-made weights (the reference init's tree with
every leaf redrawn from a seed, so norm scales, biases and decay rates are
not their trivial init values) and the same NumPy-made tokens, at
``reduced(dtype="float32")``.  On the CPU the port's kernel wrappers take
their plain versions, while the reference runs its XLA attention and chunked
SSD.  Logits and hidden states agree within 2e-4 (float32 sums in other
orders, the chunked SSD against the sequential recurrence), as do the K/V,
SSM-state and conv caches; cache ``idx`` values are equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import token_ce as jtoken_ce  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.launch.serve import run_serve  # noqa: E402
from repro_torch.models import (decode_step, forward, init_caches,  # noqa: E402
                                init_model, prefill, token_ce)
from repro_torch.models import layers as TL  # noqa: E402

TOL = 2e-4
# The archs of the serving slice; the later archs have their own files
# (tests/test_torch_moe.py, tests/test_torch_arch_zoo.py).
LM_ARCHS = ("qwen3-14b", "mamba2-1.3b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: the tensors are small, and the
    suite runs several test processes at once, where every process's thread
    pool would compete for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _close(port, ref, tol=TOL):
    if torch.is_tensor(port):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


def _cfgs(arch, **over):
    over = {"dtype": "float32", **over}
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


def _np_tree(tree, seed):
    """Every leaf redrawn around its init: value + 0.3·std·N(0, 1), with std
    the leaf's own spread (0.1 for a constant leaf)."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a, np.float32)
        std = float(a.std()) or 0.1
        return (a + 0.3 * std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(redraw, tree)


def _models(arch, seed=0, **over):
    jcfg, tcfg = _cfgs(arch, **over)
    tree = _np_tree(jinit_model(jax.random.PRNGKey(seed), jcfg)[0], seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, lm_params_from_jax(tree, tcfg, device="cpu")


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close_caches(port, ref):
    assert len(port) == len(ref)
    for pc, rc in zip(port, ref):
        assert set(pc) == set(rc)
        for key in pc:
            if key == "idx":
                assert pc[key] == int(rc[key])
            else:
                _close(pc[key], rc[key])


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_reference(arch):
    full_j, full_t = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    for over in ({}, {"dtype": "float32"}, {"vocab_size": 512}):
        red_j, red_t = full_j.reduced(**over), full_t.reduced(**over)
        assert dataclasses.asdict(red_t) == dataclasses.asdict(red_j)
        assert red_t.layer_kinds() == red_j.layer_kinds()
        assert (red_t.resolved_head_dim, red_t.ssm_d_inner,
                red_t.ssm_heads) == (red_j.resolved_head_dim,
                                     red_j.ssm_d_inner, red_j.ssm_heads)


def test_registry_covers_this_slice_and_names_the_later_ones():
    """Every reference arch is served since the VLM and audio slice; the
    decoder-only ones keep their order first."""
    assert ARCH_IDS == ["qwen3-14b", "mamba2-1.3b", "minitron-4b",
                        "granite-moe-1b-a400m", "qwen2-72b",
                        "nemotron-4-340b", "arctic-480b", "jamba-v0.1-52b",
                        "phi-3-vision-4.2b", "whisper-tiny"]
    assert set(JARCH_IDS) == set(ARCH_IDS)
    for arch in JARCH_IDS:
        assert get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_other_families_raise_not_implemented():
    """The VLM and encoder-decoder families, which raised before their
    slice, build their own subtrees now: a projector, and an encoder with
    a cross-attending decoder in place of the plain stack."""
    _, tcfg = _cfgs("qwen3-14b")
    vlm = init_model(None, dataclasses.replace(tcfg, arch_type="vlm"),
                     device="cpu")
    assert vlm["projector"]["w1"].shape == (tcfg.vision_embed_dim,
                                            tcfg.d_model)
    audio = init_model(None, dataclasses.replace(
        tcfg, is_encoder_decoder=True, encoder_layers=1), device="cpu")
    assert len(audio["encoder"]["blocks"]) == 1
    assert all("cross_attn" in b for b in audio["stack"]["blocks"])


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_norms_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5))
    _close(TL.rmsnorm_apply({"scale": _t(scale)}, _t(x), 1e-6),
           JL.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                            1e-6), 1e-5)
    _close(TL.headwise_norm_apply(_t(scale), _t(x)),
           JL.headwise_norm_apply(jnp.asarray(scale), jnp.asarray(x)), 1e-5)
    _close(TL.rope(_t(x), _t(pos), 1_000_000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0), 1e-4)


@pytest.mark.parametrize("activation", ["silu_glu", "gelu_glu", "relu2"])
def test_mlp_matches(activation):
    jcfg, tcfg = _cfgs("qwen3-14b", activation=activation)
    tree = _np_tree(JL.mlp_init(jax.random.PRNGKey(1), jcfg, 96)[0], 1)
    x = np.random.default_rng(1).standard_normal((2, 7, jcfg.d_model))
    x = x.astype(np.float32)
    _close(TL.mlp_apply({k: _t(v) for k, v in tree.items()}, _t(x), tcfg),
           JL.mlp_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                        jnp.asarray(x), jcfg))


@pytest.mark.parametrize("window", [0, 8])
def test_attention_apply_per_mode(window):
    jcfg, tcfg = _cfgs("qwen3-14b")
    tree = _np_tree(JL.attention_init(jax.random.PRNGKey(2), jcfg)[0], 2)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = {k: _t(v) for k, v in tree.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    step = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)

    y_t, _ = TL.attention_apply(tp, _t(x), tcfg, mode="train", window=window)
    y_j, _ = JL.attention_apply(jp, jnp.asarray(x), jcfg, mode="train",
                                window=window)
    _close(y_t, y_j)
    max_len = window or 20     # window == max_len: the ring-buffer cache
    jc = JL.init_kv_cache(jcfg, 2, max_len)
    tc = TL.init_kv_cache(tcfg, 2, max_len, torch.device("cpu"))
    y_t, tc = TL.attention_apply(tp, _t(x), tcfg, mode="prefill", cache=tc,
                                 window=window)
    y_j, jc = JL.attention_apply(jp, jnp.asarray(x), jcfg, mode="prefill",
                                 cache=jc, window=window)
    _close(y_t, y_j)
    _close_caches([tc], [jc])
    for _ in range(3):
        y_t, tc = TL.attention_apply(tp, _t(step), tcfg, mode="decode",
                                     cache=tc, window=window)
        y_j, jc = JL.attention_apply(jp, jnp.asarray(step), jcfg,
                                     mode="decode", cache=jc, window=window)
        _close(y_t, y_j)
        _close_caches([tc], [jc])


@pytest.mark.parametrize("s", [32, 45])
def test_mamba_apply_per_mode(s):
    jcfg, tcfg = _cfgs("mamba2-1.3b")
    tree = _np_tree(JL.mamba_init(jax.random.PRNGKey(3), jcfg)[0], 3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = {k: _t(v) for k, v in tree.items()}
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    step = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)

    y_t, _ = TL.mamba_apply(tp, _t(u), tcfg, mode="train")
    y_j, _ = JL.mamba_apply(jp, jnp.asarray(u), jcfg, mode="train")
    _close(y_t, y_j)
    tc = TL.init_ssm_cache(tcfg, 2, torch.device("cpu"))
    y_t, tc = TL.mamba_apply(tp, _t(u), tcfg, mode="prefill", cache=tc)
    y_j, jc = JL.mamba_apply(jp, jnp.asarray(u), jcfg, mode="prefill",
                             cache=JL.init_ssm_cache(jcfg, 2))
    _close(y_t, y_j)
    _close_caches([tc], [jc])
    for _ in range(2):
        y_t, tc = TL.mamba_apply(tp, _t(step), tcfg, mode="decode", cache=tc)
        y_j, jc = JL.mamba_apply(jp, jnp.asarray(step), jcfg, mode="decode",
                                 cache=jc)
        _close(y_t, y_j)
        _close_caches([tc], [jc])


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_every_decode_step_match(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    b, prompt, gen = 2, 37, 4      # 37: no multiple of the SSD chunk (32)
    toks = _tokens(b, prompt + gen, jcfg.vocab_size, seed=4)
    max_len = prompt + gen
    last_t, caches_t = prefill(tp, tcfg, {"tokens": _t(toks[:, :prompt])},
                               max_len)
    last_j, caches_j = jprefill(jp, jcfg,
                                {"tokens": jnp.asarray(toks[:, :prompt])},
                                max_len)
    _close(last_t, last_j)
    _close_caches(caches_t, caches_j)
    for i in range(prompt, prompt + gen):
        logits_t, caches_t = decode_step(tp, tcfg, _t(toks[:, i]), caches_t)
        logits_j, caches_j = jdecode_step(jp, jcfg, jnp.asarray(toks[:, i]),
                                          caches_j)
        _close(logits_t, logits_j)
        _close_caches(caches_t, caches_j)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_forward_and_token_ce_match(arch, scan_layers):
    jcfg, tcfg, jp, tp = _models(arch, seed=5, scan_layers=scan_layers,
                                 num_layers=3)
    toks = _tokens(2, 20, jcfg.vocab_size, seed=5)
    batch_t, batch_j = {"tokens": _t(toks)}, {"tokens": jnp.asarray(toks)}
    logits_t, aux_t = forward(tp, tcfg, batch_t)
    logits_j, aux_j = jforward(jp, jcfg, batch_j)
    _close(logits_t, logits_j)
    assert float(aux_t) == float(aux_j) == 0.0
    targets = np.roll(toks, -1, axis=1)
    targets[:, -1] = -1
    loss_t, m_t = token_ce(logits_t, _t(targets), with_accuracy=True)
    loss_j, m_j = jtoken_ce(logits_j, jnp.asarray(targets),
                            with_accuracy=True)
    _close(loss_t, loss_j, 1e-5)
    assert int(m_t["ntok"]) == int(m_j["ntok"])
    _close(m_t["accuracy"], m_j["accuracy"], 1e-6)


def test_sliding_window_ring_cache_matches():
    """The reference's windowed case (test_arch_smoke.py): a prompt longer
    than the window fills the ring buffer by roll, and decode over it equals
    the windowed forward at the last position."""
    jcfg, tcfg, jp, tp = _models("qwen3-14b", seed=6, sliding_window=8)
    toks = _tokens(2, 18, jcfg.vocab_size, seed=6)
    prompt = 15
    last_t, caches_t = prefill(tp, tcfg, {"tokens": _t(toks[:, :prompt])},
                               max_len=24)
    last_j, caches_j = jprefill(jp, jcfg,
                                {"tokens": jnp.asarray(toks[:, :prompt])},
                                max_len=24)
    assert caches_t[0]["k"].shape[1] == 8
    _close(last_t, last_j)
    _close_caches(caches_t, caches_j)
    for i in range(prompt, 18):
        logits_t, caches_t = decode_step(tp, tcfg, _t(toks[:, i]), caches_t)
        logits_j, caches_j = jdecode_step(jp, jcfg, jnp.asarray(toks[:, i]),
                                          caches_j)
        _close(logits_t, logits_j)
        _close_caches(caches_t, caches_j)
    full_t, _ = forward(tp, tcfg, {"tokens": _t(toks[:, :18])})
    _close(logits_t, full_t[:, -1])


# ---------------------------------------------------------------------------
# Converter, data, serving, device policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_lm_converter_round_trip_and_layer_order(arch, scan_layers):
    jcfg, tcfg = _cfgs(arch, scan_layers=scan_layers, num_layers=3)
    tree = jinit_model(jax.random.PRNGKey(7), jcfg)[0]
    port = lm_params_from_jax(tree, tcfg, device="cpu")
    blocks = port["stack"]["blocks"]
    assert isinstance(blocks, list) and len(blocks) == 3
    ref_blocks = tree["stack"]["blocks"]
    for i, block in enumerate(blocks):
        ref = (jax.tree_util.tree_map(lambda a: a[i], ref_blocks[0])
               if scan_layers else ref_blocks[i])
        flat_p = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), block))
        for got, want in zip(flat_p, jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(got, np.asarray(want))
    back = lm_params_to_jax(port, tcfg)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(
                jax.tree_util.tree_map(np.asarray, tree)))
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("vocab", [512, 50280])
def test_token_dataset_log_probs_bit_equal(vocab):
    ds = TokenDataset(vocab_size=vocab, seq_len=9, device="cpu")
    ref = JTokenDataset(vocab_size=vocab, seq_len=9)
    np.testing.assert_array_equal(ds.log_probs.numpy(),
                                  np.asarray(ref.log_probs))
    toks = ds.sample(rng.PRNGKey(0), torch.arange(12) % 10)
    assert toks.shape == (12, 9)
    assert int(toks.min()) >= 0 and int(toks.max()) < vocab


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_run_serve_on_the_cpu(arch):
    seqs, t_prefill, t_decode = run_serve(arch, batch=3, prompt_len=20,
                                          gen=4, device="cpu")
    assert seqs.shape == (3, 4) and seqs.dtype == torch.int64
    assert int(seqs.min()) >= 0 and int(seqs.max()) < 512
    assert 0 < t_prefill < 60 and 0 < t_decode < 60


def test_init_caches_layout():
    _, tcfg = _cfgs("qwen3-14b", sliding_window=8)
    caches = init_caches(tcfg, 2, 20, device="cpu")
    assert [c["k"].shape for c in caches] == [(2, 8, 2, 64)] * 2
    _, mcfg = _cfgs("mamba2-1.3b")
    caches = init_caches(mcfg, 2, 20, device="cpu")
    assert caches[0]["state"].shape == (2, 16, 32, 32)
    assert caches[0]["conv"].shape == (2, 3, 512 + 2 * 32)


def test_entry_points_without_device_raise_on_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    _, tcfg = _cfgs("qwen3-14b")
    for call in (lambda: init_model(None, tcfg),
                 lambda: run_serve("qwen3-14b", 1, 4, 2),
                 lambda: TokenDataset(),
                 lambda: init_caches(tcfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# bf16, the configs' default dtype
# ---------------------------------------------------------------------------

def test_bf16_reference_tree_converts_bit_equal():
    """``reduced()`` keeps the configs' bf16: the reference's leaves are
    ``ml_dtypes.bfloat16`` arrays, and each must arrive as a bf16 tensor
    with the same bits, and go back."""
    jcfg, tcfg = jget_config("qwen3-14b").reduced(), get_config(
        "qwen3-14b").reduced()
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    tree = jinit_model(jax.random.PRNGKey(8), jcfg)[0]
    port = lm_params_from_jax(tree, tcfg, device="cpu")
    ref_leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    port_leaves = jax.tree_util.tree_leaves(
        port, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(port_leaves) == len(ref_leaves)
    assert any(a.dtype.name == "bfloat16" for a in ref_leaves)
    for got, want in zip(port_leaves, ref_leaves):
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(jax.tree_util.tree_leaves(lm_params_to_jax(
            port, tcfg)), ref_leaves):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_bf16_prefill_and_decode_match_at_the_reference_pin(arch):
    """Both stacks at ``reduced()`` in bf16 from the same redrawn weights
    (cast to bf16 on the reference's side, converted by
    ``lm_params_from_jax``): prefill of a 37-token prompt, then 8 decode
    steps, each step's logits within the reference's own bf16 pin for
    decode ≡ forward, 2e-2 (tests/test_arch_smoke.py), taken of the
    step's largest |logit|.  Each side rounds its activations to bf16 at
    its own points (the reference's own jit and eager forms of one Mamba
    layer differ by a bf16 ulp), and a logit near 0 carries the rounding of
    the O(1) terms it sums: elementwise at rtol = atol = 2e-2 the gaps read
    up to 1.17x (qwen3-14b) and 1.82x (mamba2-1.3b) of the allowance on
    such logits, 2-3 bf16 ulps of the largest, while of the largest |logit|
    they stay within 1.41e-2 (scripts/torch_bf16_lm_gap.py, five seeds)."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    tree = _np_tree(jinit_model(jax.random.PRNGKey(9), jcfg)[0], 9)
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = lm_params_from_jax(tree, tcfg, device="cpu")
    b, prompt, gen = 2, 37, 8
    toks = _tokens(b, prompt + gen, jcfg.vocab_size, seed=10)
    last_t, caches_t = prefill(tp, tcfg, {"tokens": _t(toks[:, :prompt])},
                               prompt + gen)
    last_j, caches_j = jprefill(jp, jcfg,
                                {"tokens": jnp.asarray(toks[:, :prompt])},
                                prompt + gen)

    def close(port, ref):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(port.float().numpy(), ref, rtol=0,
                                   atol=2e-2 * np.abs(ref).max())

    close(last_t, last_j)
    for i in range(prompt, prompt + gen):
        logits_t, caches_t = decode_step(tp, tcfg, _t(toks[:, i]), caches_t)
        logits_j, caches_j = jdecode_step(jp, jcfg, jnp.asarray(toks[:, i]),
                                          caches_j)
        close(logits_t, logits_j)
