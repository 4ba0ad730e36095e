"""The order of the sums on the port's MoE capacity path
(``models/layers.py``: ``moe_apply``, ``_moe_capacity``, ``_moe_combine``),
on the CPU.

A token's k expert outputs are added one at a time in the leaf dtype in
ascending expert id, which is the order of the reference's scatter-add
``jnp.zeros((t, d)).at[st].add(contrib)`` (its sorted positions), and the
backward adds a token's k dispatched rows' gradients in the same order.
Held here:

* the forward bit-equal to a plain version written with loops (buffers
  filled token by token, each token's kept outputs added in ascending
  expert id), in bfloat16 and float32, on a hot expert that drops tokens;
  its gradients of x, the router and the experts within the pin at which
  tests/test_torch_moe.py holds them to ``jax.grad`` (1e-4 of each leaf's
  largest magnitude);
* forward and gradients bit-for-bit the same whatever order a token's k
  choices come in, and at any intra-op thread count;
* the combine alone, on the same contributions, bit-equal to the
  reference's scatter-add in bfloat16 and float32.  (Whole-layer outputs
  are held at tests/test_torch_moe.py's pins, not bit for bit: the
  experts' products round differently in XLA and in torch.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402

import torch_lm_parity as P  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: the tensors are small, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hot_layer(dtype="float32", e=4, k=2, seed=1):
    """A reduced granite-moe layer with E experts, top k, capacity factor
    0.25 and the router tilted toward expert 0, so that its buffer
    overflows; the reference's ``moe_init`` tree redrawn, x (2, 13, d)."""
    jcfg, tcfg = P.cfgs("granite-moe-1b-a400m", num_experts=e,
                        experts_per_token=k, capacity_factor=0.25,
                        moe_dropless=False)
    tree = P.np_tree(JL.moe_init(jax.random.PRNGKey(seed), jcfg)[0], seed)
    tree["router"][:, 0] += 0.5
    x = np.random.default_rng(seed).standard_normal(
        (2, 13, jcfg.d_model)).astype(np.float32)
    dt = getattr(torch, dtype)
    params = {n: P.t(v) if n == "router" else P.t(v).to(dt)
              for n, v in tree.items()}
    return jcfg, tcfg, tree, params, P.t(x).to(dt)


def _route(p, xt, k):
    """The layer's router: float32 softmax, a stable descending sort's
    first k (ties to the lower expert), gates renormalised."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    sp, si = torch.sort(probs, dim=-1, descending=True, stable=True)
    gv, gi = sp[:, :k], si[:, :k]
    return gi, gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)


def _plain_capacity(p, x, cfg):
    """The capacity path in loops: each expert's buffer filled with its
    tokens in token order up to ``cap``, the experts' products on those
    buffers, then each token's kept outputs (times their gates, in the
    leaf dtype) added one at a time in ascending expert id."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(t, d)
    gi, gv = _route(p, xt, k)
    cap = TL.moe_capacity(cfg, t)
    xbuf = torch.zeros((e, cap, d), dtype=x.dtype)
    where = {}
    for ex in range(e):
        fill = 0
        for tok in range(t):
            if ex in gi[tok].tolist() and fill < cap:
                xbuf[ex, fill] = xt[tok]
                where[tok, ex] = fill
                fill += 1
    ybuf = TL._expert_ffn(p, xbuf, cfg)
    y = torch.zeros((t, d), dtype=x.dtype)
    dropped = 0
    for tok in range(t):
        acc = None
        for j in torch.argsort(gi[tok]).tolist():
            ex = int(gi[tok, j])
            if (tok, ex) not in where:
                dropped += 1
                continue
            c = ybuf[ex, where[tok, ex]] * gv[tok, j].to(x.dtype)
            acc = c if acc is None else acc + c
        if acc is not None:
            y[tok] = acc
    return y.reshape(b, s, d), dropped


@pytest.mark.parametrize("dtype", DTYPES)
def test_capacity_forward_is_the_ascending_expert_sequential_sum(dtype):
    _, tcfg, _, p, x = _hot_layer(dtype, e=4, k=2)
    got, _ = TL.moe_apply(p, x, tcfg)
    want, dropped = _plain_capacity(p, x, tcfg)
    assert dropped > 0, "the setting must drop assignments"
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_top4_of_8_forward_is_the_ascending_expert_sequential_sum(dtype):
    """k = 4 of 8 experts: four adds a token, whose choices come from the
    router in descending probability, not in expert order."""
    _, tcfg, _, p, x = _hot_layer(dtype, e=8, k=4, seed=2)
    got, _ = TL.moe_apply(p, x, tcfg)
    want, dropped = _plain_capacity(p, x, tcfg)
    assert dropped > 0
    assert torch.equal(got, want)


def test_capacity_gradients_within_the_pins():
    """Gradients of x, the router and each expert weight against
    ``jax.grad`` of the reference on the hot-expert layer (float32)."""
    jcfg, tcfg, tree, p, x = _hot_layer("float32")
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(pp, xx):
        y, aux = JL.moe_apply(pp, xx, jcfg)
        return jnp.sum(y * w) + 3.0 * aux

    def tloss(pp, xx):
        y, aux = TL.moe_apply(pp, xx, tcfg)
        return torch.sum(y * P.t(w)) + 3.0 * aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x.numpy()))
    tg = torch.func.grad(tloss, argnums=(0, 1))(p, x)
    assert set(tg[0]) == {"router", "w_gate", "w_up", "w2"}
    P._leafwise_close({k: v.numpy() for k, v in tg[0].items()}, jg[0],
                      P.GRAD_TOL)
    P._leafwise_close([tg[1].numpy()], [jg[1]], P.GRAD_TOL)


def _capacity_grads(p, xt, gi, gv, cfg, w):
    """``_moe_capacity``'s output and the gradients of sum(y·w) in x, the
    expert weights and the gates."""
    xt = xt.detach().requires_grad_()
    gv = gv.detach().requires_grad_()
    leaves = {n: v.detach().requires_grad_() for n, v in p.items()
              if n != "router"}
    y = TL._moe_capacity(leaves, xt, gi, gv, cfg)
    grads = torch.autograd.grad((y.float() * w).sum(),
                                [xt, gv] + list(leaves.values()))
    return y.detach(), grads


@pytest.mark.parametrize("dtype", DTYPES)
def test_choice_order_changes_no_bit(dtype):
    """A token's k choices permuted before the layer's sort: the same
    output and the same gradients, bit for bit (the gates' gradients
    permuted with them)."""
    _, tcfg, _, p, x = _hot_layer(dtype, e=8, k=4, seed=3)
    xt = x.reshape(-1, x.shape[-1])
    gi, gv = _route(p, xt, tcfg.experts_per_token)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        xt.shape).astype(np.float32))
    y0, g0 = _capacity_grads(p, xt, gi, gv, tcfg, w)
    perm = torch.from_numpy(np.stack([
        np.random.default_rng(5 + i).permutation(gi.shape[1])
        for i in range(gi.shape[0])]))
    y1, g1 = _capacity_grads(p, xt, gi.gather(1, perm), gv.gather(1, perm),
                             tcfg, w)
    assert torch.equal(y0, y1)
    unperm = torch.argsort(perm, dim=1)
    assert torch.equal(g0[0], g1[0])
    assert torch.equal(g0[1], g1[1].gather(1, unperm))
    for a, b in zip(g0[2:], g1[2:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_same_bits_at_any_thread_count(dtype):
    """The layer's output and gradients at 1 and 3 intra-op threads: the
    same bits (a sum whose order follows the threads' split would not
    be)."""
    _, tcfg, _, p, x = _hot_layer(dtype, e=8, k=4, seed=6)
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        x.shape).astype(np.float32))

    def run():
        leaves = {n: v.detach().requires_grad_() for n, v in p.items()}
        xx = x.detach().requires_grad_()
        y, aux = TL.moe_apply(leaves, xx, tcfg)
        loss = (y.float() * w).sum() + 3.0 * aux
        return [y.detach()] + list(torch.autograd.grad(
            loss, [xx] + list(leaves.values())))

    one = run()
    torch.set_num_threads(3)
    three = run()
    for a, b in zip(one, three):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_combine_is_the_references_scatter_add(dtype):
    """``_moe_combine`` on NumPy-made contributions in sorted order against
    the reference's ``jnp.zeros((t, d)).at[st].add(contrib)``: bit-equal."""
    t, e, k, d = 37, 6, 3, 16
    g = np.random.default_rng(8)
    gate_idx = np.sort(np.stack([g.permutation(e)[:k] for _ in range(t)]),
                       axis=1)
    order = np.argsort(gate_idx.reshape(-1), kind="stable")
    st = order // k
    contrib = (4.0 * g.standard_normal((t * k, d))).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jc = jnp.asarray(contrib).astype(jdt)
    want = jax.jit(lambda c, s: jnp.zeros((t, d), jdt).at[s].add(c))(
        jc, jnp.asarray(st))
    got = TL._moe_combine(torch.from_numpy(np.array(jc.astype(
        jnp.float32))).to(getattr(torch, dtype)), torch.from_numpy(order), k)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
