"""Parity of the port's LM training path with the JAX reference on the CPU:
the keyed token draws and inits, ``loss_fn`` and its gradients, the SSD
backward's chunked form, the differentiable kernel Functions, AdamW and the
global-norm clip, ``make_train_step`` and ``run_train``.

On the CPU the attention and SSD Functions take their plain versions inside
the same ``torch.autograd.Function``s (and ``vmap`` rules) the card runs.
Inputs are made from seeds; the reference runs as its own code runs on the
CPU (its train step jitted on a one-device mesh).  Tolerances, each beside
the gap measured on this CPU when it was set:

* token draws and selections of rows bit-equal (gap 0);
* ``init_model``: normals within ``INIT_ULP`` = 3 ulps (the ≤ 2-ulp residual
  of ``rng.normal``, tests/test_torch_rng.py, and one rounding of the scale
  product; 3 ulps measured on 1.7e-5 of the leaves' elements); Mamba's
  ``A_log`` within 1 ulp (XLA folds ``linspace`` otherwise);
* ``loss_fn``: the loss within ``LOSS_RTOL`` = 1e-5 relative, each gradient
  leaf within ``GRAD_TOL`` = 1e-4 of its largest magnitude (gaps up to
  1.8e-6 measured);
* the chunked SSD within 1e-5 (gap 1.8e-7 of its scale) and its vjp, the
  SSD Function's backward, within 1e-5 of each gradient's scale (gap
  7.1e-7);
* the Functions: ``gradcheck`` in float64; ``vmap(grad)`` over K clients
  bit-equal to K calls, in both transform orders;
* AdamW/clip steps within ``STEP_TOL`` = 1e-5 of each leaf's largest
  magnitude (on gradients of order one);
* three ``make_train_step`` steps: losses within ``LOSS_RTOL`` (gap 1.4e-7)
  and the parameters held in norm, as chip_smoke.py phase 5 holds Adam:
  the gap between the two stacks' parameters within ``STEP_REL`` = 1e-3 of
  the reference's update (gaps 5.6e-5 with one microbatch, 5.9e-5 with
  two).  AdamW scales each coordinate by its own gradient's size, so a
  coordinate whose gradient is rounding-level moves by an lr-size step
  that float32 sums in another order change;
* ``run_train(..., reduced=True)`` trains in bfloat16 (the configs' dtype),
  so its losses are held to ``BF16_LOSS_RTOL`` = 1e-3 relative (gaps up to
  2.6e-4 measured: the two stacks round bf16 products at other points).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import sharding as jsh  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.shapes import InputShape as JInputShape  # noqa: E402
from repro.data import TokenDataset as JTokenDataset  # noqa: E402
from repro.fl.workloads import MICRO_LM_CONFIG as JMICRO  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.launch.train import synth_lm_batch as jsynth_lm_batch  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.optim import OptState as JOptState  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import apply_updates as japply_updates  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.fl.workloads import MICRO_LM_CONFIG  # noqa: E402
from repro_torch.kernels.flash_attention import gqa_flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_apply, ssd_chunked_ref  # noqa: E402
from repro_torch.launch.steps import (default_microbatches,  # noqa: E402
                                      make_train_step, opt_state_dtype,
                                      param_count)
from repro_torch.launch.train import run_train, synth_lm_batch  # noqa: E402
from repro_torch.models import init_model, loss_fn  # noqa: E402
from repro_torch.models.transformer import (flatten_params,  # noqa: E402
                                            unflatten_params)
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
INIT_ULP = 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
STEP_REL = 1e-3
BF16_LOSS_RTOL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: these tests' tensors are small,
    and the suite runs several test processes at once, where every
    process's thread pool would compete for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _ulps(a, b) -> np.ndarray:
    def order(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(order(a) - order(b))


def _cfgs(arch, **over):
    if arch == "micro":
        return (dataclasses.replace(JMICRO, **over),
                dataclasses.replace(MICRO_LM_CONFIG, **over))
    over = {"dtype": "float32", **over}
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


def _leafwise_close(port_tree, ref_tree, tol):
    """Every leaf of two reference-layout trees within ``tol`` of the
    reference leaf's largest magnitude; returns the worst relative gap."""
    worst = 0.0
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(ref_tree),
            jax.tree_util.tree_leaves(port_tree)):
        want = np.asarray(want, np.float32)
        got = np.asarray(got, np.float32)
        assert got.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        gap = float(np.abs(got - want).max()) / scale
        assert gap <= tol, (jax.tree_util.keystr(path), gap)
        worst = max(worst, gap)
    return worst


# ---------------------------------------------------------------------------
# Keyed draws: categorical, tokens, inits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 9, 2 ** 31 + 5])
def test_categorical_bit_equal(seed):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tk = rng.fold_in(rng.PRNGKey(seed), 3)
    logits = np.log(np.random.default_rng(seed).dirichlet(
        np.ones(300), size=(4,))).astype(np.float32)
    np.testing.assert_array_equal(rng.gumbel(tk, (50_000,)).numpy(),
                                  np.asarray(jax.random.gumbel(jk, (50_000,))))
    want = np.asarray(jax.random.categorical(
        jk, jnp.asarray(logits)[:, None, :], shape=(4, 33)))
    got = rng.categorical(tk, _t(logits)[:, None, :], shape=(4, 33))
    np.testing.assert_array_equal(got.numpy(), want)
    rows = rng.categorical_rows(tk, torch.arange(4) * 33 * 300, _t(logits),
                                33)
    np.testing.assert_array_equal(rows.numpy(), want)


def test_token_dataset_sample_bit_equal_and_rows_of_a_larger_draw():
    ds = TokenDataset(vocab_size=128, seq_len=8, device="cpu")
    ref = JTokenDataset(vocab_size=128, seq_len=8)
    plan = np.random.default_rng(1).integers(-1, 10, (6, 5)).astype(np.int32)
    jk = jax.random.fold_in(jax.random.PRNGKey(4), 1000)
    tk = rng.fold_in(rng.PRNGKey(4), 1000)
    want = np.asarray(ref.sample(jk, jnp.asarray(plan)))
    full = ds.sample(tk, torch.from_numpy(plan))
    np.testing.assert_array_equal(full.numpy(), want)
    rows = torch.tensor([4, 0, 4])
    np.testing.assert_array_equal(
        ds.sample(tk, torch.from_numpy(plan), rows).numpy(), want[[4, 0, 4]])
    keys = rng.fold_in(rng.PRNGKey(torch.tensor([1, 2, 3])), 5)
    labels = torch.from_numpy(np.stack([plan] * 3))
    batched = ds.sample(keys, labels, torch.tensor([[1, 2], [5, 0], [3, 3]]))
    for t, r in enumerate(([1, 2], [5, 0], [3, 3])):
        np.testing.assert_array_equal(
            batched[t].numpy(), ds.sample(keys[t], labels[t]).numpy()[r])
    domains = np.tile(np.arange(10), 3)
    np.testing.assert_array_equal(
        ds.sample(rng.PRNGKey(999), torch.from_numpy(domains)).numpy(),
        np.asarray(ref.sample(jax.random.PRNGKey(999), jnp.asarray(domains))))


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b"])
@pytest.mark.parametrize("scan_layers", [False, True])
def test_init_model_matches_reference(arch, scan_layers):
    jcfg, tcfg = _cfgs(arch, num_layers=3, scan_layers=scan_layers,
                       d_model=64, vocab_size=128)
    ref = jax.jit(lambda k: jinit_model(k, jcfg)[0])(jax.random.PRNGKey(5))
    port = lm_params_to_jax(init_model(rng.PRNGKey(5), tcfg, device="cpu"),
                            tcfg)
    assert (jax.tree_util.tree_structure(port)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                np.asarray, ref)))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(ref),
                                 jax.tree_util.tree_leaves(port)):
        limit = 1 if "A_log" in jax.tree_util.keystr(path) else INIT_ULP
        assert _ulps(got, want).max() <= limit, jax.tree_util.keystr(path)


def test_init_model_batch_of_keys_equals_each_key():
    _, tcfg = _cfgs("micro")
    keys = rng.fold_in(rng.PRNGKey(torch.tensor([0, 7])), 1)
    batch = flatten_params(init_model(keys, tcfg, device="cpu"))
    for i in range(2):
        one = flatten_params(init_model(keys[i], tcfg, device="cpu"))
        assert set(one) == set(batch)
        for k in one:
            assert torch.equal(batch[k][i], one[k]), k


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

def _batch(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s))
    targets = np.roll(toks, -1, axis=1)
    targets[:, -1] = -1
    targets[0, 3] = -1                     # an ignored position
    return toks.astype(np.int32), targets.astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b", "micro"])
def test_loss_fn_and_gradients_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    tree = jinit_model(jax.random.PRNGKey(6), jcfg)[0]
    toks, targets = _batch(jcfg.vocab_size, 2, 45, 6)   # 45: ragged chunk

    def jl(p):
        return jloss_fn(p, jcfg, {"tokens": jnp.asarray(toks),
                                  "targets": jnp.asarray(targets)})[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(jl))(tree)
    flat = lm_params_from_jax(tree, tcfg, device="cpu", flat=True)

    def tl(p):
        return loss_fn(unflatten_params(p), tcfg,
                       {"tokens": _t(toks).long(),
                        "targets": _t(targets).long()})[0]

    tgrads, tloss = torch.func.grad_and_value(tl)(flat)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    worst = _leafwise_close(lm_params_to_jax(tgrads, tcfg), jgrads, GRAD_TOL)
    print(f"{arch}: loss gap {abs(float(tloss) - float(jloss)):.2e}, "
          f"worst gradient leaf {worst:.2e}")


def test_ssd_chunked_ref_and_vjp_match_reference():
    rng_ = np.random.default_rng(7)
    b, s, h, p, g, n, chunk = 2, 32, 4, 8, 2, 16, 8
    x = rng_.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng_.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.3 * rng_.standard_normal(h)).astype(np.float32)
    B, C = ((0.5 * rng_.standard_normal((b, s, g, n))).astype(np.float32)
            for _ in range(2))
    wy = rng_.standard_normal((b, s, h, p)).astype(np.float32)
    wf = rng_.standard_normal((b, h, p, n)).astype(np.float32)
    args = (x, dt, A, B, C)

    def jf(*a):
        y, fin = JL._ssd_chunked(*a, chunk)
        return (y * wy).sum() + (fin * wf).sum()

    jval, jgrads = jax.jit(jax.value_and_grad(jf, argnums=tuple(range(5))))(
        *(jnp.asarray(a) for a in args))
    y, fin = ssd_chunked_ref(*(_t(a) for a in args), chunk)
    yj, finj = jax.jit(JL._ssd_chunked, static_argnums=5)(
        *(jnp.asarray(a) for a in args), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(fin.numpy(), np.asarray(finj), rtol=1e-5,
                               atol=1e-5)
    ts = [_t(a).requires_grad_() for a in args]
    y, fin = ssd_apply(*ts, chunk=chunk)     # the Function: its backward
    ((y * _t(wy)).sum() + (fin * _t(wf)).sum()).backward()
    for t, want in zip(ts, jgrads):
        scale = float(np.abs(np.asarray(want)).max())
        assert float((t.grad - _t(want)).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# The differentiable kernel Functions on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,kv", [(True, 0, 2), (True, 3, 4),
                                              (False, 0, 1), (False, 2, 2)])
def test_flash_function_gradcheck(causal, window, kv):
    gen = torch.Generator().manual_seed(window + kv)
    q = torch.randn(1, 5, 4, 4, dtype=torch.float64, generator=gen)
    k, v = (torch.randn(1, 5, kv, 4, dtype=torch.float64, generator=gen)
            for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda *a: gqa_flash_attention(*a, causal=causal, window=window),
        tuple(t.requires_grad_() for t in (q, k, v)))


def _ssd_args(lead, dtype, seed, b=2, s=16, h=4, p=3, g=2, n=5):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(lead + (b, s, h, p), dtype=dtype, generator=gen)
    dt = torch.nn.functional.softplus(
        torch.randn(lead + (b, s, h), dtype=dtype, generator=gen))
    A = -torch.exp(0.3 * torch.randn(lead + (h,), dtype=dtype, generator=gen))
    B, C = (0.5 * torch.randn(lead + (b, s, g, n), dtype=dtype,
                              generator=gen) for _ in range(2))
    return [x, dt, A, B, C]


def test_ssd_function_gradcheck():
    args = [t.requires_grad_() for t in _ssd_args((), torch.float64, 0, b=1,
                                                   s=8, h=2, p=2, g=1, n=3)]
    assert torch.autograd.gradcheck(
        lambda *a: [o.sum(-1) for o in ssd_apply(*a, chunk=4)], args)


def _attn_case():
    gen = torch.Generator().manual_seed(11)
    q = torch.randn(5, 2, 9, 4, 16, generator=gen)
    k, v = (torch.randn(5, 2, 9, 2, 16, generator=gen) for _ in range(2))
    w = torch.randn(2, 9, 4, 16, generator=gen)

    def loss(q, k, v):
        return (gqa_flash_attention(q, k, v, window=4) * w).sum()
    return loss, (q, k, v)


def _ssd_case():
    args = _ssd_args((5,), torch.float32, 1)
    w = torch.randn(2, 16, 4, 3, generator=torch.Generator().manual_seed(2))

    def loss(*a):
        y, fin = ssd_apply(*a, chunk=8)
        return (y * w).sum() + fin.sum()
    return loss, args


@pytest.mark.parametrize("case", [_attn_case, _ssd_case],
                         ids=["flash_attention", "ssd_scan"])
def test_vmap_grad_bit_equal_to_separate_calls_in_both_orders(case):
    loss, args = case()
    argnums = tuple(range(len(args)))
    batched = torch.func.vmap(torch.func.grad(loss, argnums))(*args)
    outer = torch.func.grad(
        lambda *a: torch.func.vmap(loss)(*a).sum(), argnums)(*args)
    for i in range(args[0].shape[0]):
        one = torch.func.grad(loss, argnums)(*(a[i] for a in args))
        for got, want in zip(batched, one):
            assert torch.equal(got[i], want)
    for a, b in zip(batched, outer):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# AdamW, the clip, the train step and run_train
# ---------------------------------------------------------------------------

def test_adamw_and_clip_steps_match_reference():
    g = np.random.default_rng(8)
    params = {"a": g.standard_normal((5, 7)).astype(np.float32),
              "b": g.standard_normal(11).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    jopt, topt = jadamw(3e-4), adamw(3e-4)
    jst, tst = jopt.init(jp), topt.init(tp)
    for step in range(4):
        grads = {k: (3.0 * g.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        jg, jnorm = jclip({k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
        tg, tnorm = clip_by_global_norm({k: _t(v) for k, v in grads.items()},
                                        1.0)
        assert abs(float(tnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
        jups, jst = jopt.update(jg, jst, jp)
        tups, tst = topt.update(tg, tst, tp)
        jp, tp = japply_updates(jp, jups), apply_updates(tp, tups)
        _leafwise_close(tp, jp, STEP_TOL)
        _leafwise_close(tst.mu, jst.mu, STEP_TOL)
        _leafwise_close(tst.nu, jst.nu, STEP_TOL)
    assert tst.step == int(jst.step) == 4


def test_optimizer_state_dtype_and_microbatches_follow_the_reference():
    from repro.launch.steps import default_microbatches as jdefault_mb
    from repro.launch.steps import param_count as jparam_count
    full_j, full_t = jget_config("qwen3-14b"), get_config("qwen3-14b")
    assert param_count(full_t) == jparam_count(full_j) > 10e9
    assert opt_state_dtype(full_t) == torch.bfloat16
    for arch in ("qwen3-14b", "mamba2-1.3b"):
        jcfg, tcfg = jget_config(arch), get_config(arch)
        assert param_count(tcfg.reduced()) == jparam_count(jcfg.reduced())
        assert opt_state_dtype(tcfg.reduced()) == torch.float32
        for seq, gb in ((4096, 256), (1024, 4), (128, 24)):
            got = default_microbatches(tcfg, InputShape("s", seq, gb, "train"))
            assert got == jdefault_mb(jcfg, JInputShape("s", seq, gb, "train"))


def _one_device_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _ref_steps(jcfg, mb, batches, steps):
    """The reference's make_train_step, jitted and called on a one-device
    mesh inside its sharding context."""
    mesh = _one_device_mesh()
    shape = JInputShape("custom", batches[0]["tokens"].shape[1],
                        batches[0]["tokens"].shape[0], "train")
    fn, in_sh, out_sh, _, rules = jmake_train_step(jcfg, mesh, shape,
                                                   microbatches=mb)
    params = jinit_model(jax.random.PRNGKey(0), jcfg)[0]
    zeros = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda p: jnp.zeros(p.shape, jnp.float32), params)
    state = JOptState(step=jnp.zeros((), jnp.int32), mu=zeros(), nu=zeros())
    losses = []
    with mesh, jsh.shard_ctx(mesh, rules):
        jitted = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        for i in range(steps):
            params, state, m = jitted(params, state, batches[i])
            losses.append(float(m["loss"]))
    return params, losses


@pytest.mark.parametrize("mb", [1, 2])
def test_make_train_step_matches_reference(mb):
    jcfg, tcfg = _cfgs("qwen3-14b", d_model=64, vocab_size=128)
    ds = JTokenDataset(vocab_size=jcfg.vocab_size, seq_len=24)
    key = jax.random.PRNGKey(0)
    batches = [jsynth_lm_batch(ds, jax.random.fold_in(key, i), 4)
               for i in range(3)]
    jparams, jlosses = _ref_steps(jcfg, mb, batches, 3)
    step, opt = make_train_step(tcfg, InputShape("c", 24, 4, "train"), mb)
    params = init_model(rng.PRNGKey(0), tcfg, device="cpu")
    state = opt.init(flatten_params(params))
    losses = []
    for b in batches:
        params, state, m = step(params, state, {k: _t(v).long()
                                                for k, v in b.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    init = jax.tree_util.tree_leaves(lm_params_to_jax(
        init_model(rng.PRNGKey(0), tcfg, device="cpu"), tcfg))
    got = jax.tree_util.tree_leaves(lm_params_to_jax(params, tcfg))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jparams)]
    gap = np.sqrt(sum(((g - w) ** 2).sum() for g, w in zip(got, want)))
    upd = np.sqrt(sum(((w - i) ** 2).sum() for w, i in zip(want, init)))
    print(f"microbatches {mb}: parameter gap {gap / upd:.2e} of the update")
    assert gap <= STEP_REL * upd, gap / upd


def _ref_run_train(arch, steps, batch, seq):
    """The reference's run_train (repro/launch/train.py) with its steps
    called inside the mesh's sharding context, where jax 0.9 traces them."""
    jcfg = jget_config(arch).reduced(vocab_size=512)
    ds = JTokenDataset(vocab_size=jcfg.vocab_size, seq_len=seq)
    key = jax.random.PRNGKey(0)
    batches = [jsynth_lm_batch(ds, jax.random.fold_in(key, i), batch)
               for i in range(steps)]
    return _ref_steps(jcfg, 1, batches, steps)[1]


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b"])
def test_run_train_matches_reference(arch):
    want = _ref_run_train(arch, 2, 2, 32)
    got = run_train(arch, 2, 2, 32, reduced=True, device="cpu")
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)


def test_synth_batch_bit_equal():
    ds = TokenDataset(vocab_size=512, seq_len=16, device="cpu")
    jds = JTokenDataset(vocab_size=512, seq_len=16)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    want = jsynth_lm_batch(jds, key, 5)
    got = synth_lm_batch(ds, rng.fold_in(rng.PRNGKey(0), 2), 5)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "2"], cwd=ROOT, capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                        "OMP_NUM_THREADS": "1"}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout


def test_run_train_checkpoints_and_device_policy(tmp_path):
    losses = run_train("qwen3-14b", 1, 1, 8, True, ckpt_dir=str(tmp_path),
                       device="cpu")
    meta = json.loads((tmp_path / "ckpt_00000001.json").read_text())
    assert meta == {"step": 1, "extra": {"arch": "qwen3-14b",
                                         "loss": losses[-1]}}
    assert (tmp_path / "ckpt_00000001.npz").is_file()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_train("qwen3-14b", 1, 1, 8, True)


def test_flat_params_round_trip():
    _, tcfg = _cfgs("mamba2-1.3b", num_layers=3, d_model=64, vocab_size=128)
    nested = init_model(rng.PRNGKey(2), tcfg, device="cpu")
    flat = flatten_params(nested)
    assert "stack.blocks.2.mamba.in_proj" in flat
    back = unflatten_params(flat)
    assert isinstance(back["stack"]["blocks"], list)
    assert flatten_params(back).keys() == flat.keys()
    for k in flat:
        assert flatten_params(back)[k] is flat[k]


def test_training_modules_are_under_the_import_check():
    """tests/test_torch_core.py checks every module of the port for jax and
    repro imports; the training slice's new modules are among them."""
    sources = set((ROOT / "src" / "repro_torch").rglob("*.py"))
    for rel in ("launch/steps.py", "launch/train.py", "configs/shapes.py"):
        assert ROOT / "src" / "repro_torch" / rel in sources
