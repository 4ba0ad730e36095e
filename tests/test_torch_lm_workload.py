"""Parity of the port's ``lm`` FL workload (federated LM pretraining over
domain-skewed token streams) with the JAX reference on the CPU: the
registered micro config, the materializer, the eval set, the flat params
the engines carry, and whole ``run(ExperimentSpec(workload="lm"))`` runs on
the ``sim`` and ``host`` engines, and on ``hier`` and ``async``.

Tolerances, each beside the gap measured on this CPU when it was set:
tokens, histograms, inits' structure and selections bit-equal (gap 0; the
selections through ``num_selected`` and the ``selected_label_hist``
telemetry series); init leaves within 3 ulps (tests/test_torch_train.py);
one client's loss within 1e-5 relative (gap 2e-7); whole runs' eval loss
within ``RUN_LOSS_RTOL`` = 1e-4 relative (gaps 1.6e-7 on sim and host,
2.4e-7 on hier and async) and accuracy within 2 of the eval set's
next-token predictions (gap 0).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fl as J  # noqa: E402
from repro.configs.paper_cnn import FLConfig as JFLConfig  # noqa: E402
from repro.fl.workloads import MICRO_LM_CONFIG as JMICRO  # noqa: E402

import repro_torch.fl as T  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.fl.workloads import MICRO_LM_CONFIG, get_workload  # noqa: E402

RUN_LOSS_RTOL = 1e-4
INIT_ULP = 3
ROUNDS = 2
FL = dict(num_clients=6, clients_per_round=3, global_epochs=ROUNDS,
          local_epochs=1, batch_size=4)



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


def _spec(engine, **kw):
    scenario = J.ScenarioSpec.from_bias_mix(
        0.7, name="domain-skew", num_classes=10, n_min=8, n_max=8,
        num_rounds=ROUNDS)
    return J.ExperimentSpec(
        scenarios=(scenario,), strategies=("labelwise",), seeds=(0,),
        engine=engine, workload="lm", fl=JFLConfig(**FL), eval_n_per_class=2,
        telemetry=("selected_label_hist",), **kw)


def _wl():
    jwl, twl = J.get_workload("lm"), get_workload("lm")
    return jwl, twl, jwl.make_dataset(), twl.make_dataset("cpu")


BUILTIN_WORKLOADS = ("cnn", "lm")


def _builtins_match_reference():
    """The reference's builtins, as a prefix: the JAX registry is global to
    the process, so names that other test files register into it (and
    never remove) may follow them."""
    n = len(BUILTIN_WORKLOADS)
    assert (J.registered_workloads()[:n] == T.registered_workloads()[:n]
            == BUILTIN_WORKLOADS)


def test_micro_config_and_registry_match_reference():
    assert (dataclasses.asdict(MICRO_LM_CONFIG)
            == dataclasses.asdict(JMICRO))
    _builtins_match_reference()
    jwl, twl, jds, tds = _wl()
    assert twl.batch_keys == jwl.batch_keys
    assert twl.num_classes(tds) == jwl.num_classes(jds) == 10
    np.testing.assert_array_equal(tds.log_probs.numpy(),
                                  np.asarray(jds.log_probs))


def test_registry_comparison_ignores_test_only_registrations():
    """A name registered into the reference's registry by another test (as
    tests/test_registry_contracts.py does) does not change the comparison,
    whichever files share a test process."""
    from repro.fl import workloads as jw
    name = "_throwaway_lm_workload_test"
    J.register_workload(name, J.get_workload("lm"))
    try:
        assert name in J.registered_workloads()
        assert name not in T.registered_workloads()
        _builtins_match_reference()
    finally:
        jw._WORKLOADS.pop(name, None)
    assert name not in J.registered_workloads()


def test_materialize_sample_and_eval_set_bit_equal():
    jwl, twl, jds, tds = _wl()
    plan = np.random.default_rng(3).integers(-1, 10, (6, 8)).astype(np.int32)
    jk = jax.random.fold_in(jax.random.PRNGKey(2), 1000)
    want = jwl.materialize(jds, jnp.asarray(plan), jk)
    got = twl.materialize(tds, plan, rng.fold_in(rng.PRNGKey(2), 1000))
    for key in ("tokens", "labels", "valid", "hists"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    # The grid draws the selected rows only, under a batch of keys.
    keys = rng.fold_in(rng.PRNGKey(torch.tensor([2, 2])), 1000)
    rows = torch.tensor([[5, 0, 3], [1, 1, 4]])
    part = twl.sample(tds, keys, torch.from_numpy(np.stack([plan] * 2)),
                      rows)["tokens"]
    for t in range(2):
        np.testing.assert_array_equal(part[t].numpy(),
                                      np.asarray(want["tokens"])[rows[t]])
    jev, tev = jwl.eval_set(jds, 2), twl.eval_set(tds, 2)
    for key in ("tokens", "targets"):
        np.testing.assert_array_equal(tev[key].numpy(), np.asarray(jev[key]))


def test_flat_init_loss_and_eval_match_reference():
    jwl, twl, jds, tds = _wl()
    jk = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jparams = jax.jit(lambda k: jwl.init(k, jds))(jk)
    tparams = twl.init(rng.fold_in(rng.PRNGKey(0), 1), tds)
    assert all("." in k and torch.is_tensor(v) for k, v in tparams.items())
    back = lm_params_to_jax(tparams, MICRO_LM_CONFIG)
    for want, got in zip(jax.tree_util.tree_leaves(jparams),
                         jax.tree_util.tree_leaves(back)):
        assert _ulps(got, want).max() <= INIT_ULP
    flat = lm_params_from_jax(jparams, MICRO_LM_CONFIG, device="cpu",
                              flat=True)
    assert flat.keys() == tparams.keys()
    plan = np.random.default_rng(4).integers(-1, 10, (2, 8)).astype(np.int32)
    data = jwl.materialize(jds, jnp.asarray(plan), jk)
    batch = {k: np.array(data[k][0]) for k in ("tokens", "labels", "valid")}
    jloss, _ = jax.jit(jwl.make_loss(jds))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _ = twl.make_loss(tds)(flat, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jl, jm = jax.jit(jwl.make_eval(jds))(jparams, jwl.eval_set(jds, 2))
    tl, tm = twl.make_eval(tds)(flat, twl.eval_set(tds, 2))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert int(tm["n"]) == int(jm["n"])


def _run_both(engine, **kw):
    spec = _spec(engine, **kw)
    return J.run(spec), T.run(T.ExperimentSpec.from_dict(spec.to_dict()),
                              device="cpu")


def _check_run(ref, port):
    np.testing.assert_array_equal(port.num_selected, ref.num_selected)
    np.testing.assert_array_equal(
        port.telemetry()["selected_label_hist"],
        np.asarray(ref.telemetry()["selected_label_hist"]))
    np.testing.assert_allclose(port.loss, ref.loss, rtol=RUN_LOSS_RTOL)
    ntok = 10 * 2 * 15                 # 2 sequences a domain, 15 targets
    assert np.abs(port.accuracy - ref.accuracy).max() <= 2 / ntok
    assert np.isfinite(port.loss).all() and port.loss.shape[-1] == ROUNDS


@pytest.mark.parametrize("engine", ["sim", "host"])
def test_run_lm_spec_matches_reference(engine):
    _check_run(*_run_both(engine))


@pytest.mark.parametrize("engine,options", [
    ("hier", {"num_blocks": 2}), ("async", {"num_blocks": 2, "tau_max": 1})])
def test_lm_on_the_population_engines_matches_reference(engine, options):
    _check_run(*_run_both(engine, engine_options=options))


def test_lm_workload_of_another_config_checks_its_vocabulary():
    cfg = dataclasses.replace(MICRO_LM_CONFIG, name="lm-v128",
                              vocab_size=128)
    wl = T.lm_workload(cfg, num_domains=4, seq_len=8)
    ds = wl.make_dataset("cpu")
    assert (ds.vocab_size, ds.num_domains, ds.seq_len) == (128, 4, 8)
    with pytest.raises(ValueError, match="vocab_size"):
        wl.make_loss(get_workload("lm").make_dataset("cpu"))


def test_register_workload_takes_the_check_keyword():
    """As the reference's: ``check=False`` registers, ``check=True`` (the
    contract pass, not ported) raises naming its ROADMAP item and registers
    nothing."""
    before = T.registered_workloads()
    wl = get_workload("cnn")
    assert T.register_workload("cnn", wl, overwrite=True, check=False) is wl
    assert T.registered_workloads() == before
    with pytest.raises(NotImplementedError, match="item 16"):
        T.register_workload("_checked_workload", wl, check=True)
    assert T.registered_workloads() == before
