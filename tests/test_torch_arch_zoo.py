"""Parity of the remaining decoder-only archs with the JAX reference on the
CPU: minitron-4b (squared-ReLU MLP), qwen2-72b (QKV bias), nemotron-4-340b
(squared-ReLU; head_dim 192 at full width) and the hybrid jamba-v0.1-52b
(Mamba and attention layers, a MoE every other layer, a period of 8 layers
in the reference's stacked layout).

The whole-model checks and their tolerances are tests/torch_lm_parity.py's
(2e-4 for logits and caches; in bf16 each layer within one bf16 ulp).  The
plain attention at head_dim 192, the path a CPU tensor takes through the
flash wrappers, is held to the reference's attention at the same 2e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402

import torch_lm_parity as P  # noqa: E402
from repro_torch.kernels.flash_attention import gqa_flash_attention  # noqa: E402,E501
from repro_torch.launch.serve import run_serve  # noqa: E402

ARCHS = ("minitron-4b", "qwen2-72b", "nemotron-4-340b", "jamba-v0.1-52b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: the tensors are small, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    P.check_configs(arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_init_model_matches_reference(arch, scan_layers):
    P.check_init_model(arch, scan_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_token_ce_match(arch):
    P.check_forward_and_token_ce(arch, scan_layers=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_gradients_match(arch):
    P.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_match(arch):
    P.check_prefill_and_decode(arch, gen=8)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_lm_converter_round_trip(arch, scan_layers):
    P.check_converter_round_trip(arch, scan_layers, num_layers=3)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_jamba_period_of_eight_crosses_the_converter(scan_layers):
    """jamba's published pattern at small width: 16 layers, attention at
    layer 4 of each 8, a MoE every other layer; with ``scan_layers`` the
    reference stacks 2 repeats of an 8-block superblock."""
    period, reps = P.check_converter_round_trip(
        "jamba-v0.1-52b", scan_layers, num_layers=16, attn_layer_period=8,
        attn_layer_offset=4, moe_layer_period=2, d_model=64,
        vocab_size=64)
    assert (period, reps) == ((8, 2) if scan_layers else (16, 1))


def test_jamba_layer_kinds_at_full_width():
    kinds = P.get_config("jamba-v0.1-52b").layer_kinds()[:8]
    assert kinds == [("mamba", "dense"), ("mamba", "moe"),
                     ("mamba", "dense"), ("mamba", "moe"),
                     ("attn", "dense"), ("mamba", "moe"),
                     ("mamba", "dense"), ("mamba", "moe")]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layers_match_within_one_ulp(arch):
    """Each layer kind in bf16 against the reference's jitted layer.  For
    jamba this is the bf16 check: its whole-model gap to the reference
    reads 0.014-0.026 of the largest |logit| over seeds (a routing flip
    much more), where the reference's own jitted and eager steps differ by
    as much (scripts/torch_bf16_lm_gap.py), so the 2e-2 pin holds neither
    form of the reference against the other."""
    P.check_bf16_layers(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    P.check_param_counts(arch)


@pytest.mark.parametrize("window", [0, 40])
def test_plain_attention_at_head_dim_192_matches(window):
    """nemotron-4-340b's head_dim 192 and its 12 q-heads a kv-head, at a
    small S: the flash wrapper on CPU tensors against the reference's
    attention (its XLA ``_sdpa`` through ``attention_apply``'s mask)."""
    g = np.random.default_rng(11)
    b, s, h, kv, d = 2, 77, 24, 2, 192
    q = g.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (g.standard_normal((b, s, kv, d)).astype(np.float32)
            for _ in range(2))
    mask = jnp.asarray(np.asarray(JL.causal_mask(s, s, window=window)))
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, kv)
    got = gqa_flash_attention(P.t(q), P.t(k), P.t(v), causal=True,
                              window=window)
    P.close(got, want)


def test_nemotron_gradients_at_head_dim_192_match():
    """``loss_fn`` and its gradients of nemotron-4-340b at
    ``reduced(head_dim=192)``, its published head_dim, through the
    attention backward at 192 (on the CPU its plain version), against
    ``jax.grad`` of the reference, at tests/torch_lm_parity.py's limits."""
    P.check_loss_and_grads("nemotron-4-340b", head_dim=192)


def test_run_serve_and_num_layers_on_the_cpu():
    """The reduced hybrid through ``run_serve`` and ``num_layers``: 4 layers
    give 2 attention layers of jamba's reduced period of 2."""
    seqs, t_prefill, t_decode = run_serve("jamba-v0.1-52b", batch=2,
                                          prompt_len=20, gen=3, device="cpu",
                                          num_layers=4)
    assert seqs.shape == (2, 3) and int(seqs.max()) < 512
    assert 0 < t_prefill and 0 < t_decode
