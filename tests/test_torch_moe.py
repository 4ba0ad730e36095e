"""Parity of the port's mixture of experts (``models/layers.py``:
``moe_init``, ``_expert_ffn``, ``moe_apply``) and of the two MoE archs,
granite-moe-1b-a400m and arctic-480b (whose every block adds a dense
residual MLP to the MoE), with the JAX reference on the CPU.

Inputs are made from seeds with NumPy; the reference runs jitted.  The
layer is held at the reference's own float32 pin, 2e-4
(tests/test_torch_lm.py), in three settings: ample capacity
(``capacity_factor=8``) at (E, k) = (4, 1), (4, 2) and (8, 4); a hot expert
at ``capacity_factor=0.25``, where the dropped tokens' rows must be
exactly zero where the reference's are; and dropless.  The aux loss is held
within 1e-6 relative (a few float32 ulps: the softmax's ``exp`` and the
means' sums round in other orders; gaps of one ulp measured).  Gradients
against ``jax.grad`` within 1e-4 of each leaf's largest magnitude
(tests/test_torch_train.py's ``GRAD_TOL``), and ``vmap(grad)`` over 3
clients against the reference's ``vmap(grad)`` likewise.  The whole-model
checks and their tolerances are tests/torch_lm_parity.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402

import torch_lm_parity as P  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "arctic-480b")
AUX_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: the tensors are small, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

def _layer(e, k, cf, dropless, hot=False, seed=1):
    """Reduced granite-moe configs with E experts, top k; the reference's
    ``moe_init`` tree, every leaf redrawn; x (2, 13, d).  ``hot`` tilts the
    router toward expert 0, so its buffer overflows."""
    jcfg, tcfg = P.cfgs("granite-moe-1b-a400m", num_experts=e,
                        experts_per_token=k, capacity_factor=cf,
                        moe_dropless=dropless)
    tree = P.np_tree(JL.moe_init(jax.random.PRNGKey(seed), jcfg)[0], seed)
    if hot:
        tree["router"][:, 0] += 0.5
    x = np.random.default_rng(seed).standard_normal(
        (2, 13, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, tree, x


SETTINGS = {"e4k1": (4, 1, 8.0, False), "e4k2": (4, 2, 8.0, False),
            "e8k4": (8, 4, 8.0, False), "dropless": (4, 2, 1.25, True)}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_moe_apply_matches(name):
    jcfg, tcfg, tree, x = _layer(*SETTINGS[name])
    y_j, aux_j = jax.jit(JL.moe_apply, static_argnums=(2,))(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x), jcfg)
    y_t, aux_t = TL.moe_apply({k: P.t(v) for k, v in tree.items()}, P.t(x),
                              tcfg)
    P.close(y_t, y_j)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=AUX_RTOL)
    if not tcfg.moe_dropless:     # ample capacity: nothing is dropped
        assert TL.moe_capacity(tcfg, 26) >= 26


def test_moe_hot_expert_drops_what_the_reference_drops():
    jcfg, tcfg, tree, x = _layer(4, 2, 0.25, False, hot=True)
    y_j, aux_j = jax.jit(JL.moe_apply, static_argnums=(2,))(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x), jcfg)
    y_t, aux_t = TL.moe_apply({k: P.t(v) for k, v in tree.items()}, P.t(x),
                              tcfg)
    y_j = np.asarray(y_j)
    assert TL.moe_capacity(tcfg, 26) == 8
    zero_j = (y_j == 0).all(-1)
    zero_t = (y_t == 0).all(-1).numpy()
    assert zero_j.any(), "the setting must drop whole tokens"
    np.testing.assert_array_equal(zero_t, zero_j)
    P.close(y_t, y_j)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=AUX_RTOL)


def test_moe_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: jax.lax.top_k
    takes experts 0..k-1, and so must the port."""
    jcfg, tcfg, tree, x = _layer(4, 2, 8.0, True)
    tree["router"][:] = 0.0
    y_j, _ = JL.moe_apply({k: jnp.asarray(v) for k, v in tree.items()},
                          jnp.asarray(x), jcfg)
    y_t, _ = TL.moe_apply({k: P.t(v) for k, v in tree.items()}, P.t(x),
                          tcfg)
    P.close(y_t, y_j)
    only01 = dict(tree, w2=tree["w2"] * np.array([1, 1, 0, 0], np.float32)[
        :, None, None])
    y_01, _ = TL.moe_apply({k: P.t(v) for k, v in only01.items()}, P.t(x),
                           tcfg)
    assert torch.equal(y_01, y_t)


def test_moe_init_matches():
    """Keyed ``moe_init`` in a bf16 config: the router float32, the experts
    bf16, each within ``INIT_ULP`` of the reference's draw."""
    from repro_torch import rng
    jcfg, tcfg = P.cfgs("arctic-480b", dtype="bfloat16", d_model=64)
    ref = jax.jit(lambda k: JL.moe_init(k, jcfg)[0])(jax.random.PRNGKey(3))
    port = TL.moe_init(rng.PRNGKey(3), tcfg)
    assert port["router"].dtype == torch.float32
    assert port["w_gate"].dtype == torch.bfloat16
    for name, want in ref.items():
        got = port[name].float().numpy()
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape, name
        assert P.ulps(got, want).max() <= P.INIT_ULP, name


def _grad_case(dropless):
    jcfg, tcfg, tree, x = _layer(4, 2, 1.25 if dropless else 0.5, dropless)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JL.moe_apply(p, xx, jcfg)
        return jnp.sum(y * w) + 3.0 * aux

    def tloss(p, xx):
        y, aux = TL.moe_apply(p, xx, tcfg)
        return torch.sum(y * P.t(w)) + 3.0 * aux

    return tree, x, jloss, tloss


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_moe_gradients_match_jax_grad(dropless):
    tree, x, jloss, tloss = _grad_case(dropless)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x))
    tg = torch.func.grad(tloss, argnums=(0, 1))(
        {k: P.t(v) for k, v in tree.items()}, P.t(x))
    P._leafwise_close({k: v.numpy() for k, v in tg[0].items()}, jg[0],
                      P.GRAD_TOL)
    P._leafwise_close([tg[1].numpy()], [jg[1]], P.GRAD_TOL)


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_moe_vmap_grad_over_three_clients(dropless):
    """The ``lm`` FL workload's transform: ``vmap(grad)`` over 3 clients'
    params and inputs, against the reference's ``vmap(grad)``, and each
    client equal to its own ``grad`` call."""
    tree, x, jloss, tloss = _grad_case(dropless)
    g = np.random.default_rng(3)
    trees = {k: np.stack([v * (1 + 0.1 * i) for i in range(3)])
             for k, v in tree.items()}
    xs = np.stack([x + 0.5 * g.standard_normal(x.shape).astype(np.float32)
                   for _ in range(3)])
    jg = jax.jit(jax.vmap(jax.grad(jloss)))(
        {k: jnp.asarray(v) for k, v in trees.items()}, jnp.asarray(xs))
    tp = {k: P.t(v) for k, v in trees.items()}
    tg = torch.func.vmap(torch.func.grad(tloss))(tp, P.t(xs))
    P._leafwise_close({k: v.numpy() for k, v in tg.items()}, jg, P.GRAD_TOL)
    for i in range(3):
        one = torch.func.grad(tloss)({k: v[i] for k, v in tp.items()},
                                     P.t(xs[i]))
        for k in one:
            torch.testing.assert_close(tg[k][i], one[k], rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# The two MoE archs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    P.check_configs(arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_init_model_matches_reference(arch, scan_layers):
    P.check_init_model(arch, scan_layers)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_forward_and_token_ce_match(arch, scan_layers):
    P.check_forward_and_token_ce(arch, scan_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_with_aux_and_gradients_match(arch):
    P.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_match(arch):
    P.check_prefill_and_decode(arch, gen=8)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_lm_converter_round_trip(arch, scan_layers):
    P.check_converter_round_trip(arch, scan_layers, num_layers=3)


def test_converter_keeps_the_router_float32_in_a_bf16_tree():
    jcfg, tcfg = P.cfgs("granite-moe-1b-a400m", dtype="bfloat16")
    tree = P.layout_tree(jcfg, seed=7)
    port = P.lm_params_from_jax(tree, tcfg, device="cpu")
    moe = port["stack"]["blocks"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    back = P.lm_params_to_jax(port, tcfg)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_bf16_prefill_and_decode_match_at_the_reference_pin():
    P.check_bf16_pin("granite-moe-1b-a400m")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layers_match_within_one_ulp(arch):
    P.check_bf16_layers(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    P.check_param_counts(arch)


def test_capacity_routing_runs_the_model_path():
    """The published configs route with capacity (``moe_dropless`` off):
    a reduced model with capacity routing equals the reference's forward."""
    jcfg, tcfg, jp, tp = P.models("granite-moe-1b-a400m", seed=3,
                                  moe_dropless=False, capacity_factor=1.0)
    toks = P.tokens(2, 24, jcfg.vocab_size, seed=3)
    from repro_torch.models import forward
    logits_t, aux_t = forward(tp, tcfg, {"tokens": P.t(toks)})
    logits_j, aux_j = P._jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    P.close(logits_t, logits_j)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=AUX_RTOL)


def test_dryrun_traces_a_reduced_moe_prefill():
    """One reduced granite-moe prefill step traced over fake tensors: one
    ``flash_attention`` node a layer and no other kernel node (the MoE is
    plain products)."""
    cfg = P.get_config("granite-moe-1b-a400m").reduced()
    step, args = steps.make_prefill_step(cfg, InputShape("p", 48, 2,
                                                         "prefill"))
    gm = dryrun.trace_step(step, args)
    nodes = dryrun.kernel_nodes(gm)
    assert nodes["flash_attention"] == cfg.num_layers
    assert sum(nodes.values()) == cfg.num_layers
