"""The port's robust aggregation and adversary behaviors against the
reference's, on the CPU: the ``median``/``trimmed_mean``/``krum`` reducers,
``resolve_adversary``, the poisoned and stale round, and whole attacked
runs through ``run(spec)`` on the ``sim`` and ``host`` engines.

Tolerances:

* ``median`` is bit-equal (sorts are exact and 0.5·(a + b) rounds alike);
  ``trimmed_mean`` is held to 1 ulp and is in fact bit-equal (the port sums
  the sorted slots left to right, as the reference's CPU code does);
  ``krum`` must pick the same client, so its result is bit-equal, and the
  test prints the score margin of the pick.  Dead slots, live counts
  c ∈ {0, 1, 2, odd, even, all} and varied sizes are covered.
* The attacked round's params: rtol 1e-5 / atol 1e-6, as the clean round
  (``tests/test_torch_round.py``); per-client update norms rtol 1e-5.
* Whole runs: ``case2b`` (a round's one majority label on 12 of each
  client's 16 samples, the other 4 spread over the other labels; the
  ``flip+poison`` attack also flips the byzantine clients' labels), 6
  clients, 3 a round, 12×12 images, Adam at lr 1e-3 as the paper trains,
  two byzantine clients, 2 rounds, seed 0.  Measured on the CPU (the
  tests print each gap): port ≡ reference within 3.9e-7 relative in loss
  on both engines, for all three reducers and both attacks; port sim ≡
  port host bit for bit; accuracy and ``num_selected`` equal.  Loss is held to ``LOSS_RTOL = 1e-5``,
  tightened from ``tests/test_torch_experiment.py``'s 5e-5; accuracy to
  ``ACC_ATOL = 1e-6``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fl.experiment as jx  # noqa: E402
from repro.configs.paper_cnn import FLConfig as JFLConfig  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import noniid as jnoniid  # noqa: E402
from repro.data import client_batches as jclient_batches  # noqa: E402
from repro.data.synthetic import ImageDataset as JImageDataset  # noqa: E402
from repro.fl.round import make_fl_round as jmake_fl_round  # noqa: E402
from repro.fl.round import resolve_adversary as jresolve  # noqa: E402
from repro.models.cnn import cnn_init as jcnn_init  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402

import repro_torch.fl.experiment as tx  # noqa: E402
from repro_torch.configs import FLConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.data import ImageDataset, client_batches  # noqa: E402
from repro_torch.fl import make_fl_round  # noqa: E402
from repro_torch.fl.round import resolve_adversary  # noqa: E402
from repro_torch.kernels.dispatch import client_histograms  # noqa: E402
from repro_torch.models import cnn_loss  # noqa: E402

LOSS_RTOL = 1e-5
ACC_ATOL = 1e-6
C, HW = 10, 12
N, PER_ROUND, SAMPLES = 6, 3, 16
ROBUST = ("median", "trimmed_mean", "krum")


def _stack(g, s):
    """A client stack shaped like the CNN's leaves, each slot at its own
    offset so Krum's distances have a clear order."""
    off = g.standard_normal(s).astype(np.float32)
    tree = {"conv.w": g.standard_normal((s, 4, 1, 3, 3)),
            "conv.b": g.standard_normal((s, 4)),
            "fc.w": 3.0 * g.standard_normal((s, 24, 10))}
    return {k: (v + off.reshape((s,) + (1,) * (v.ndim - 1))).astype(
        np.float32) for k, v in tree.items()}


def _live(g, s, c):
    live = np.zeros(s, np.float32)
    live[g.permutation(s)[:c]] = 1
    return live


CASES = [(s, c) for s in (1, 5, 30) for c in sorted({0, 1, 2, 3, 4, 7, s})
         if c <= s]


def _both(name, tree, live, sizes):
    ref = jax.jit(lambda t, l, w: jagg.get_aggregator(name).reduce(t, l, w))(
        tree, live, sizes)
    port = tagg.get_aggregator(name).reduce(
        {k: torch.from_numpy(v) for k, v in tree.items()},
        torch.from_numpy(live), torch.from_numpy(sizes))
    return {k: np.asarray(v) for k, v in ref.items()}, {
        k: v.numpy() for k, v in port.items()}


def _ulps(a, b):
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return np.abs(a - b)


# ---------------------------------------------------------------------------
# The reducers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,c", CASES)
def test_median_bit_equal(s, c):
    g = np.random.default_rng(100 * s + c)
    ref, port = _both("median", _stack(g, s), _live(g, s, c),
                      g.uniform(1, 300, s).astype(np.float32))
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    if c == 0:
        assert np.isinf(port["fc.w"]).all()   # the count = 0 guard's case


@pytest.mark.parametrize("s,c", CASES)
def test_trimmed_mean_within_one_ulp(s, c):
    g = np.random.default_rng(200 * s + c)
    ref, port = _both("trimmed_mean", _stack(g, s), _live(g, s, c),
                      g.uniform(1, 300, s).astype(np.float32))
    for k in ref:
        assert int(_ulps(port[k], ref[k]).max()) <= 1, k


@pytest.mark.parametrize("s,c", CASES)
def test_krum_picks_the_reference_client(s, c):
    g = np.random.default_rng(300 * s + c)
    tree, live = _stack(g, s), _live(g, s, c)
    ref, port = _both("krum", tree, live,
                      g.uniform(1, 300, s).astype(np.float32))
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    scores = np.sort(tagg.krum_scores(
        {k: torch.from_numpy(v)[None] for k, v in tree.items()},
        torch.from_numpy(live)[None])[0].numpy())
    if c >= 2:
        print(f"krum S={s} c={c}: best score {scores[0]:.6g}, margin to the "
              f"next {(scores[1] - scores[0]) / scores[0]:.3e} relative")


@pytest.mark.parametrize("frac", [0.1, 0.3, 0.45])
def test_trimmed_mean_fractions_and_krum_assumption(frac):
    g = np.random.default_rng(7)
    tree, live = _stack(g, 30), _live(g, 30, 23)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    for jf, tf in ((jagg.make_trimmed_mean(frac), tagg.make_trimmed_mean(frac)),
                   (jagg.make_krum(frac), tagg.make_krum(frac))):
        ref = jf(jt, jnp.asarray(live))
        port = tf(tt, torch.from_numpy(live))
        for k in tree:
            assert int(_ulps(port[k].numpy(), np.asarray(ref[k])).max()) <= 1
    for bad in (-0.1, 0.5):
        with pytest.raises(ValueError):
            tagg.make_trimmed_mean(bad)
        with pytest.raises(ValueError):
            tagg.make_krum(bad)


@pytest.mark.parametrize("name", ROBUST)
def test_reducers_take_a_trial_axis(name):
    """One call over (T, S, …) equals T one-trial calls, bit for bit."""
    g = np.random.default_rng(11)
    tree = {k: np.stack([v, v[::-1] * 2, v + 1]) for k, v in
            _stack(g, 9).items()}
    live = np.stack([_live(g, 9, c) for c in (9, 4, 0)])
    fn = tagg.get_aggregator(name).reduce
    assert fn.trial_axis
    both = fn({k: torch.from_numpy(v) for k, v in tree.items()},
              torch.from_numpy(live))
    for t in range(3):
        one = fn({k: torch.from_numpy(v[t]) for k, v in tree.items()},
                 torch.from_numpy(live[t]))
        for k in tree:
            assert torch.equal(both[k][t], one[k]), (name, t, k)


def test_register_with_check_names_its_item():
    """``check=True`` runs the contract pass over a custom reduce: one that
    returns the stacked tree (the wrong shapes) raises ``ContractError``
    with the reference's code, A201, and registers nothing; the median
    reduce registers."""
    from repro_torch.analysis import ContractError
    with pytest.raises(ContractError) as ei:
        tagg.register_aggregator(
            "robust_custom", lambda stacked, live, sizes: stacked,
            check=True, device="cpu")
    assert {d.code for d in ei.value.findings.errors()} == {"A201"}
    assert "robust_custom" not in tagg.registered_aggregators()
    try:
        agg = tagg.register_aggregator("robust_custom", tagg.median_reduce,
                                       check=True, device="cpu")
        assert agg.reduce is tagg.median_reduce
        assert "robust_custom" in tagg.registered_aggregators()
    finally:
        tagg.AGGREGATORS.pop("robust_custom", None)
        if "robust_custom" in tagg._AGG_REGISTRY_ORDER:
            tagg._AGG_REGISTRY_ORDER.remove("robust_custom")


@pytest.mark.parametrize("adversary", [
    None, {}, {"frac": 0.2}, {"behaviors": ["poison"]},
    {"behaviors": ("poison", "stale_update"), "scale": -4.0, "tau": 3},
    {"behaviors": ["stale_update"], "tau": 0}])
def test_resolve_adversary_matches_reference(adversary):
    assert resolve_adversary(adversary) == jresolve(adversary)


def test_resolve_adversary_rejects_what_the_reference_rejects():
    for bad in ({"behaviors": ["label_flip"]},
                {"behaviors": ["stale_update"], "tau": -1}):
        with pytest.raises(ValueError):
            jresolve(bad)
        with pytest.raises(ValueError):
            resolve_adversary(bad)


# ---------------------------------------------------------------------------
# The attacked round, on the same batches and init
# ---------------------------------------------------------------------------

def _cfg(cls, **kw):
    base = dict(num_clients=N, clients_per_round=PER_ROUND, global_epochs=2,
                local_epochs=1, batch_size=8, lr=1e-2, optimizer="sgd")
    base.update(kw)
    return cls(**base)


def _round_data(plan_t, seed):
    rng = np.random.default_rng(seed)
    means = np.random.default_rng(99).standard_normal((C, HW, HW, 1))
    labels = np.asarray(plan_t, np.int32)
    valid = labels >= 0
    images = (means[np.maximum(labels, 0)]
              + 0.35 * rng.standard_normal(labels.shape + (HW, HW, 1)))
    images = (images * valid[..., None, None, None]).astype(np.float32)
    return {"images": images, "labels": labels, "valid": valid}


@pytest.mark.parametrize("aggregation,optimizer", [
    ("fedavg", "adam"), ("fedsgd", "sgd"), ("median", "sgd"),
    ("krum", "adam")])
def test_attacked_round_matches_reference(aggregation, optimizer):
    """Two rounds with ``poison`` (scale −4) and, for FedAvg families,
    ``stale_update`` (the previous round's params as the stale base), and
    the per-client update norms."""
    stale = aggregation != "fedsgd"
    plan = jnoniid.case_label_plan("iid", 4, 2, N, samples_per_client=SAMPLES,
                                   majority=12)
    adv = jnoniid.adversary_mask(3, N, 0.5)
    kw = dict(poison_scale=-4.0, with_stale=stale, want_client_norms=True)
    cfg = dict(optimizer=optimizer, lr=1e-3 if optimizer == "adam" else 1e-2)
    jround = jmake_fl_round(lambda p, b: jcnn_loss(p, b["images"],
                                                   b["labels"], b["valid"]),
                            _cfg(JFLConfig, **cfg), "random", aggregation, **kw)
    tround = make_fl_round(lambda p, b: cnn_loss(p, b["images"], b["labels"],
                                                 b["valid"]),
                           _cfg(FLConfig, **cfg), "random", aggregation, **kw)
    init = jcnn_init(jax.random.PRNGKey(2), num_classes=C, image_size=HW,
                     c1=4, c2=6, hidden=16)
    jp, tp = init, params_from_jax(init, device="cpu")
    jold, told = jp, tp
    from repro_torch import rng
    for t in range(2):
        data = _round_data(plan[t], seed=t)
        jdata = {k: jnp.asarray(v) for k, v in data.items()}
        tdata = {k: torch.from_numpy(v) for k, v in data.items()}
        th = client_histograms(torch.where(tdata["valid"], tdata["labels"], 0),
                               C, tdata["valid"])
        jkey = jax.random.fold_in(jax.random.PRNGKey(5), t)
        tkey = rng.fold_in(rng.PRNGKey(5), t)
        jnew, jinfo = jround(jp, jclient_batches(jdata, 8),
                             jnp.asarray(th.numpy()), jkey,
                             jnp.asarray(adv, jnp.float32), jold)
        tnew, tinfo = tround(tp, client_batches(tdata, 8), th, tkey,
                             torch.from_numpy(adv.astype(np.float32)), told)
        for k in ("selected", "live", "mask", "num_selected"):
            np.testing.assert_array_equal(np.asarray(tinfo[k]),
                                          np.asarray(jinfo[k]), err_msg=k)
        assert float((adv[np.asarray(jinfo["selected"])]).sum()) > 0
        np.testing.assert_allclose(tinfo["client_update_norms"].numpy(),
                                   np.asarray(jinfo["client_update_norms"]),
                                   rtol=1e-5, atol=1e-6)
        back = params_to_jax(tnew)
        for layer in jnew:
            for name in jnew[layer]:
                np.testing.assert_allclose(back[layer][name],
                                           np.asarray(jnew[layer][name]),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{layer}.{name}")
        jold, told = jp, tp
        jp, tp = jnew, tnew


# ---------------------------------------------------------------------------
# Whole attacked runs through run(spec), both engines, both stacks
# ---------------------------------------------------------------------------

ATTACKS = {
    "flip+poison": {"frac": 0.34, "behaviors": ["poison"], "scale": -4.0},
    "stale": {"frac": 0.34, "behaviors": ["stale_update"], "tau": 1},
}


def _spec(mod, cfg_cls, engine, aggregation, attack):
    transforms = ((mod.label_flip(0.34),) if attack == "flip+poison" else ())
    return mod.ExperimentSpec(
        scenarios=(mod.ScenarioSpec.from_case(
            "case2b", samples_per_client=SAMPLES, majority=12,
            transforms=transforms),),
        strategies=("labelwise",), seeds=(0,), engine=engine,
        fl=_cfg(cfg_cls, optimizer="adam", lr=1e-3), eval_n_per_class=2,
        aggregation=aggregation, adversary=ATTACKS[attack])


@pytest.fixture(scope="module")
def attacked_runs():
    jds = JImageDataset(image_size=HW)
    tds = ImageDataset(image_size=HW, device="cpu")
    out = {}
    for agg in ROBUST:
        for attack in ATTACKS:
            for engine in ("sim", "host"):
                ref_spec = _spec(jx, JFLConfig, engine, agg, attack)
                out[("ref", agg, attack, engine)] = jx.run(ref_spec, ds=jds)
                out[("port", agg, attack, engine)] = tx.run(
                    tx.ExperimentSpec.from_dict(ref_spec.to_dict()), ds=tds,
                    device="cpu")
    return out


def _assert_runs_close(port, ref):
    np.testing.assert_array_equal(port.num_selected, ref.num_selected)
    np.testing.assert_allclose(port.loss, ref.loss, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(port.accuracy, ref.accuracy, rtol=0,
                               atol=ACC_ATOL)


@pytest.mark.parametrize("engine", ["sim", "host"])
@pytest.mark.parametrize("attack", sorted(ATTACKS))
@pytest.mark.parametrize("aggregation", ROBUST)
def test_attacked_runs_match_reference(attacked_runs, aggregation, attack,
                                       engine):
    port = attacked_runs[("port", aggregation, attack, engine)]
    ref = attacked_runs[("ref", aggregation, attack, engine)]
    assert port.accuracy.shape == (1, 1, 1, 2)
    _assert_runs_close(port, ref)
    print(f"{aggregation} {attack} {engine}: loss within "
          f"{np.max(np.abs(port.loss - ref.loss) / np.abs(ref.loss)):.2e} "
          "relative of the reference")


@pytest.mark.parametrize("attack", sorted(ATTACKS))
@pytest.mark.parametrize("aggregation", ROBUST)
def test_attacked_grid_equals_port_host(attacked_runs, aggregation, attack):
    sim = attacked_runs[("port", aggregation, attack, "sim")]
    host = attacked_runs[("port", aggregation, attack, "host")]
    _assert_runs_close(sim, host)
    print(f"{aggregation} {attack}: sim within "
          f"{np.max(np.abs(sim.loss - host.loss) / np.abs(host.loss)):.2e} "
          "relative of host")


def test_the_attack_moves_the_run(attacked_runs):
    """Poison at scale −4 against the same spec without behaviors: the
    trajectories differ, so the hooks really ran."""
    spec = _spec(tx, FLConfig, "sim", "median", "flip+poison")
    clean = tx.run(dataclasses.replace(spec, adversary={"frac": 0.34}),
                   ds=ImageDataset(image_size=HW, device="cpu"), device="cpu")
    attacked = attacked_runs[("port", "median", "flip+poison", "sim")]
    assert not np.array_equal(clean.loss, attacked.loss)


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_attacked_result_json_loads_across(attacked_runs, direction):
    src = attacked_runs[("port" if direction == "port-to-ref" else "ref",
                         "krum", "flip+poison", "host")]
    dst = jx if direction == "port-to-ref" else tx
    back = dst.ExperimentResult.from_json(src.to_json())
    for name in ("accuracy", "loss", "num_selected"):
        np.testing.assert_array_equal(getattr(back, name), getattr(src, name))
    assert back.table1() == src.table1()
    assert json.loads(back.to_json()) == json.loads(src.to_json())


def test_validate_rejects_stale_update_with_fedsgd():
    spec = dataclasses.replace(_spec(tx, FLConfig, "sim", "fedsgd", "stale"))
    with pytest.raises(ValueError, match="stale"):
        spec.validate()
    with pytest.raises(ValueError, match="stale"):
        jx.ExperimentSpec.from_dict(spec.to_dict()).validate()
    ok = _spec(tx, FLConfig, "host", "krum", "flip+poison")
    ok.validate()
    jx.ExperimentSpec.from_dict(ok.to_dict()).validate()


@pytest.mark.parametrize("aggregation,adversary", [
    ("clustered_fedavg", {}),
    ("median", {"frac": 0.34, "behaviors": ["poison", "stale_update"],
                "scale": -4.0, "tau": 1})])
def test_grid_trained_in_chunks_equals_one_pass(monkeypatch, aggregation,
                                                adversary):
    """Each chunk of trials builds its own start models (cluster models,
    stale bases) and poisons its own slots: a grid trained two trials a
    call, as a card short of memory would split it, gives the one pass's
    trajectories bit for bit."""
    import repro_torch.fl.sim as tsim
    spec = dataclasses.replace(
        _spec(tx, FLConfig, "sim", aggregation, "stale"),
        strategies=("random", "labelwise"), seeds=(0, 1), adversary=adversary)
    tds = ImageDataset(image_size=HW, device="cpu")
    one = tx.run(spec, ds=tds, device="cpu")
    monkeypatch.setattr(tsim, "_chunk_trials", lambda device, per, trials: 2)
    chunked = tx.run(spec, ds=tds, device="cpu")
    assert chunked.meta["sim"]["chunk_trials"] == 2
    assert one.meta["sim"]["chunk_trials"] == 4
    for name in ("accuracy", "loss", "num_selected"):
        assert np.array_equal(getattr(chunked, name), getattr(one, name))
    if aggregation.startswith("clustered"):
        assert np.array_equal(chunked.cluster_trajectories()["assign"],
                              one.cluster_trajectories()["assign"])
