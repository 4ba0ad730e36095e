"""Activation rematerialisation in the port's training forward against the
JAX reference on the CPU: ``cfg.remat`` and ``cfg.remat_policy`` (``full``
| ``dots``) in ``stack_apply_train``, the train step and the dry-run.

The configs are micro cuts of three families with the reference's scanned
layout (``scan_layers=True``) and more than one repeat of its superblock,
so that remat applies: qwen3-14b (dense attention, a superblock of one
layer), mamba2-1.3b (Mamba, one layer) and jamba-v0.1-52b (a period of two:
a Mamba layer and an attention layer with the MoE), 4 layers each, float32,
where the kernel wrappers take their plain versions.  Both stacks get the
same NumPy-made weights and tokens (tests/torch_lm_parity.py's
conventions); the reference's ``value_and_grad`` is jitted.  Checks and
their tolerances:

* remat on against remat off in the port, under each policy: the loss and
  every gradient bit-equal (the same ops on the same values, the aux losses
  summed a layer at a time either way);
* the port under remat against the reference's rematerialised ``loss_fn``
  under the same config: the loss within ``LOSS_RTOL`` = 1e-5 relative,
  each gradient leaf within ``GRAD_TOL`` = 1e-4 of its largest magnitude
  (tests/test_torch_train.py's pins, through tests/torch_lm_parity.py);
* what runs again, counted by a ``TorchDispatchMode`` over the loss and its
  gradients: under ``full`` every kernel forward op (``repro_torch::
  flash_attention``, ``repro_torch::ssd_scan``) twice and, with the
  recompute's early stop off, every ``mm``/``addmm`` of the stack's forward
  once more; under ``dots`` the kernel forward ops twice and the products
  (``DOTS_SAVED_OPS``) no more than without remat; a policy the reference
  does not name takes ``full``;
* a microbatched ``make_train_step`` step under remat: params, moments and
  loss bit-equal to the same step without remat;
* the dry-run of a rematerialised train step: a lower liveness peak, a
  lower ``useful_flops_fraction`` and twice the kernel forward nodes; a
  ``reduced()`` config turns remat off as the reference's does, so the
  policy changes nothing there; the CLI's ``--remat-policy`` reaches the
  config and the record.
"""
import functools
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import set_checkpoint_early_stop  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402,E501
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models.transformer import (DOTS_SAVED_OPS,  # noqa: E402
                                            stack_apply_train, stack_plan,
                                            unflatten_params)

import torch_lm_parity as P  # noqa: E402

ARCHS = ("qwen3-14b", "mamba2-1.3b", "jamba-v0.1-52b")
POLICIES = ("full", "dots")
MICRO = dict(dtype="float32", num_layers=4, d_model=64, vocab_size=128,
             scan_layers=True)
KERNEL_FWD = ("repro_torch::flash_attention", "repro_torch::ssd_scan")
KERNEL_BWD = ("repro_torch::flash_attention_bwd", "repro_torch::ssd_scan_bwd")
PRODUCTS = tuple(f"aten::{op._overloadpacket.__name__}"
                 for op in DOTS_SAVED_OPS)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: these tests' tensors are small,
    and the suite runs several test processes at once, where every
    process's thread pool would compete for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, remat=True, policy="full", **more):
    over = {**MICRO, "remat": remat, "remat_policy": policy, **more}
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference-layout weights of ``arch``'s micro config (remat does
    not change the tree) and a batch of 2 × 45 tokens with an ignored
    target."""
    jcfg, _ = _cfgs(arch)
    tree = P.np_tree(jax.jit(lambda k: jinit_model(k, jcfg)[0])(
        jax.random.PRNGKey(6)), 6)
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 45)).astype(np.int32)
    targets = np.roll(toks, -1, axis=1)
    targets[:, -1] = -1
    targets[0, 3] = -1
    return tree, toks, targets


class OpCount(TorchDispatchMode):
    """Counts each op that reaches the dispatcher, as ``namespace::name``.
    The CPU form of ``repro_torch::ssd_scan_bwd`` differentiates with
    ``torch.func.vjp``, which needs the dispatch keys that a mode's handler
    runs without, so the kernel ops run under the keys of the mode's
    entry."""

    def __enter__(self):
        self.counts = Counter()
        self.keys = (torch._C._dispatch_tls_local_include_set(),
                     torch._C._dispatch_tls_local_exclude_set())
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[f"{func.namespace}::{func._overloadpacket.__name__}"] += 1
        if func.namespace == "repro_torch":
            with torch._C._ForceDispatchKeyGuard(*self.keys):
                return func(*args, **(kwargs or {}))
        return func(*args, **(kwargs or {}))


def _port(arch, remat, policy="full", early_stop=True):
    """(loss, gradients in the reference's layout, op counts) of the port's
    ``loss_fn`` under ``torch.autograd.grad``, as the train step takes
    them."""
    tree, toks, targets = _weights(arch)
    _, tcfg = _cfgs(arch, remat, policy)
    flat = lm_params_from_jax(tree, tcfg, device="cpu", flat=True)
    leaves = {k: p.requires_grad_() for k, p in flat.items()}
    batch = {"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(targets).long()}
    with OpCount() as ops, set_checkpoint_early_stop(early_stop):
        loss = loss_fn(unflatten_params(leaves), tcfg, batch)[0]
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), lm_params_to_jax(dict(zip(leaves, grads)), tcfg),
            ops.counts)


@functools.lru_cache(maxsize=None)
def _port_cached(arch, remat, policy="full", early_stop=True):
    return _port(arch, remat, policy, early_stop)


def _stack_forward_counts(arch):
    """Op counts of the stack's forward alone, its params and input
    requiring gradients as in training (``matmul`` folds to ``mm`` by the
    operands' ``requires_grad``)."""
    tree, _, _ = _weights(arch)
    _, tcfg = _cfgs(arch, remat=False)
    params = lm_params_from_jax(tree, tcfg, device="cpu")
    for p in jax.tree_util.tree_leaves(params["stack"]):
        p.requires_grad_()
    x = torch.randn(2, 45, tcfg.d_model, requires_grad=True)
    with OpCount() as ops:
        stack_apply_train(params["stack"], x, tcfg)
    return ops.counts


def _leaves_equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


@pytest.mark.parametrize("arch", ARCHS)
def test_micro_configs_rematerialise(arch):
    """Each micro config has more than one superblock, so remat applies."""
    jcfg, tcfg = _cfgs(arch)
    period = {"jamba-v0.1-52b": 2}.get(arch, 1)
    assert stack_plan(tcfg)[1:] == (period, 4 // period)
    assert (tcfg.remat, tcfg.remat_policy) == (jcfg.remat,
                                               jcfg.remat_policy)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_to_no_remat(arch, policy):
    loss, grads, _ = _port_cached(arch, True, policy)
    loss0, grads0, _ = _port_cached(arch, False)
    assert torch.equal(loss, loss0)
    assert _leaves_equal(grads, grads0)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_the_reference(arch, policy):
    tree, toks, targets = _weights(arch)
    jcfg, _ = _cfgs(arch, True, policy)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, jb)[0]))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    loss, grads, _ = _port_cached(arch, True, policy)
    assert abs(float(loss) - float(jloss)) <= P.LOSS_RTOL * abs(float(jloss))
    P._leafwise_close(grads, jgrads, P.GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_op_counts_show_what_is_recomputed(arch):
    _, _, off = _port_cached(arch, False)
    _, _, full = _port_cached(arch, True, "full")
    _, _, whole = _port(arch, True, "full", early_stop=False)
    _, _, dots = _port_cached(arch, True, "dots")
    fwd = _stack_forward_counts(arch)
    kernels = [k for k in KERNEL_FWD if off[k]]
    assert kernels
    for k in kernels:
        assert fwd[k] == off[k]
        assert full[k] == dots[k] == whole[k] == 2 * off[k], k
    for k in KERNEL_BWD:
        assert full[k] == dots[k] == off[k], k
    products = sum(fwd[p] for p in PRODUCTS)
    assert products
    # full: the recompute runs the stack's products again; with early
    # stopping on (the default) it stops once a superblock's last saved
    # tensor is back, which may leave that superblock's last product out
    # (a product's inputs are saved before it runs).
    assert sum(whole[p] - off[p] for p in PRODUCTS) == products
    assert 0 < sum(full[p] - off[p] for p in PRODUCTS) <= products
    # dots: the products are saved, none runs again.
    assert sum(dots[p] for p in PRODUCTS) == sum(off[p] for p in PRODUCTS)


def test_an_unnamed_policy_takes_full():
    """The reference's ``else`` branch: any policy but ``dots`` is
    ``jax.checkpoint`` without a policy."""
    loss, grads, counts = _port("mamba2-1.3b", True, "offload")
    _, _, full = _port_cached("mamba2-1.3b", True, "full")
    loss0, grads0, _ = _port_cached("mamba2-1.3b", False)
    assert counts == full
    assert torch.equal(loss, loss0) and _leaves_equal(grads, grads0)


@pytest.mark.parametrize("policy", POLICIES)
def test_microbatched_train_step_is_bit_equal_to_no_remat(policy):
    arch = "jamba-v0.1-52b"
    tree, _, _ = _weights(arch)
    toks = np.random.default_rng(8).integers(0, 128, (4, 33))
    targets = np.roll(toks, -1, axis=1)
    targets[:, -1] = -1
    batch = {"tokens": torch.from_numpy(toks), "targets":
             torch.from_numpy(targets)}
    out = []
    for remat in (False, True):
        _, tcfg = _cfgs(arch, remat, policy)
        step, opt = steps.make_train_step(
            tcfg, InputShape("c", 33, 4, "train"), microbatches=2)
        params = lm_params_from_jax(tree, tcfg, device="cpu")
        state = opt.init(steps.flatten_params(params))
        params, state, m = step(params, state, batch)
        out.append((steps.flatten_params(params), state, m))
    (p0, s0, m0), (p1, s1, m1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert torch.equal(s0.mu[k], s1.mu[k]), k
        assert torch.equal(s0.nu[k], s1.nu[k]), k


def _dry(arch, cfg, seq=64):
    return dryrun.dryrun_step(arch, cfg, InputShape("t", seq, 2, "train"),
                              microbatches=1)


def test_dryrun_sees_the_recompute_and_the_freed_activations():
    arch = "jamba-v0.1-52b"
    _, on = _cfgs(arch, True, "full")
    _, off = _cfgs(arch, False)
    rec, rec0 = _dry(arch, on), _dry(arch, off)
    assert (rec["remat"], rec["remat_policy"]) == (True, "full")
    assert rec0["remat"] is False
    assert rec["peak_memory_per_device"] < rec0["peak_memory_per_device"]
    assert rec["useful_flops_fraction"] < rec0["useful_flops_fraction"]
    assert rec["model_flops"] == rec0["model_flops"]
    for k, n in rec0["kernel_launches"].items():
        assert rec["kernel_launches"][k] == (2 * n if k in ("flash_attention",
                                                            "ssd_scan")
                                             else n), k
    assert not rec["note"]


def test_dryrun_notes_that_it_does_not_trace_dots():
    _, cfg = _cfgs("mamba2-1.3b", True, "dots", num_layers=2)
    rec = _dry("mamba2-1.3b", cfg, seq=32)
    assert rec["remat_policy"] == "dots"
    assert rec["note"] == dryrun.DOTS_NOTE


def test_reduced_configs_turn_remat_off_as_the_reference():
    """``reduced()`` sets remat off (and the plain layout) in both stacks,
    so a policy alone changes nothing: the same graph under either."""
    for arch in ARCHS:
        assert get_config(arch).remat and jget_config(arch).remat
        assert not get_config(arch).reduced().remat
        assert not jget_config(arch).reduced().remat
    shape = InputShape("t", 32, 2, "train")
    recs = [dryrun.dryrun_step("mamba2-1.3b", get_config(
        "mamba2-1.3b").reduced(d_model=64, remat_policy=p), shape,
        microbatches=1) for p in POLICIES]
    for key in ("kernel_launches", "flops_per_device", "nodes",
                "peak_memory_per_device"):
        assert recs[0][key] == recs[1][key], key


@pytest.mark.parametrize("policy", POLICIES)
def test_dryrun_cli_takes_the_remat_policy(policy, monkeypatch):
    """``--remat-policy`` reaches the traced config and the record (the
    trace itself stubbed: a full-width train_4k trace takes minutes)."""
    seen = {}

    def fake_step(arch, cfg, shape, microbatches=None, **kw):
        seen["cfg"] = cfg
        return {"remat": cfg.remat, "remat_policy": cfg.remat_policy}

    monkeypatch.setattr(dryrun, "dryrun_step", fake_step)
    records, one = [], dryrun.dryrun_one

    def quiet_one(*args, **kw):
        records.append(one(*args, **{**kw, "verbose": False}))
        return records[-1]

    monkeypatch.setattr(dryrun, "dryrun_one", quiet_one)
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "train_4k",
                        "--remat-policy", policy, "--no-save"]) == 0
    assert seen["cfg"].remat and seen["cfg"].remat_policy == policy
    assert records[0]["overrides"] == {"remat_policy": policy}
