"""The port's experiment surface against the reference's, on the CPU:
scenario transforms and ``ScenarioSpec.lower``, ``select_random`` and
``dirichlet_uniformity``, ``ExperimentSpec``/``ExperimentResult`` JSON, whole
``run_fl_host`` runs, and ``run(spec)`` through the ``sim`` and ``host``
engines.

Tolerances, from the values measured on these micro specs (6 clients, 2–3 a
round, 12×12 images, a narrow CNN):

* Plans, masks, selections and ``num_selected`` are bit-equal: the draws
  are the reference's (NumPy, threefry) and the scores round as its
  compiled CPU code does.
* Trajectories: the two stacks train with other convolution kernels, so a
  round's parameters differ in the last bits, and Adam turns a last-bit
  gradient difference on a near-zero coordinate into up to a learning-rate
  step.  Measured: port host ≡ reference host within 4.1e-6 in loss (1.2e-6
  relative) over 3 rounds; port sim ≡ port host within 1.1e-6; the
  reference's own sim ≡ host gap on the grid spec is 1.55e-5 (1.2e-5
  relative), and port sim ≡ reference sim lands inside it (1.5e-5).  Loss
  is held to ``LOSS_RTOL = 5e-5`` relative, about 3× the reference's own
  engine gap.  Accuracy counts eval samples: a flipped sample moves it by
  1/20 here, so accuracy is held to ``ACC_ATOL = 1e-6`` (float32 rounding
  of the same count); no sample flips in these runs.
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
from repro.core import noniid as jnoniid  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.data.synthetic import ImageDataset as JImageDataset  # noqa: E402
from repro.fl import run_fl as jrun_fl  # noqa: E402

import repro_torch.fl.experiment as tx  # noqa: E402
import repro_torch.fl.sim as tsim  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import FLConfig  # noqa: E402
from repro_torch.core import noniid as tnoniid  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.data import ImageDataset  # noqa: E402
from repro_torch.fl import (grid_arrays, run_fl, run_fl_host,  # noqa: E402
                            run_grid, simulate)
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.weighted_agg import weighted_agg_ref  # noqa: E402

LOSS_RTOL = 5e-5
ACC_ATOL = 1e-6
HW = 12
N, PER_ROUND, SAMPLES = 6, 3, 16


def _cfg(cls, **kw):
    base = dict(num_clients=N, clients_per_round=PER_ROUND, global_epochs=3,
                local_epochs=1, batch_size=8, lr=1e-3, optimizer="adam")
    base.update(kw)
    return cls(**base)


def _assert_trajectories(port, ref):
    np.testing.assert_array_equal(np.asarray(port.num_selected),
                                  np.asarray(ref.num_selected))
    np.testing.assert_allclose(np.asarray(port.loss), np.asarray(ref.loss),
                               rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(np.asarray(port.accuracy),
                               np.asarray(ref.accuracy), rtol=0,
                               atol=ACC_ATOL)


# ---------------------------------------------------------------------------
# Scenario transforms and lowering
# ---------------------------------------------------------------------------

def _plan(seed=3, t=4):
    return jnoniid.case_label_plan("case2b", seed, t, 9, samples_per_client=20,
                                   majority=14)


@pytest.mark.parametrize("transform", [
    "availability_plan", "apply_availability", "adversary_mask",
    "flip_labels", "quantity_skew"])
def test_transforms_bit_equal(transform):
    plan = _plan()
    if transform == "availability_plan":
        args = [(s, 4, 9, p, m) for s in (0, 5) for p, m in
                ((0.3, 1), (0.9, 3), (1.0, 2))]
    elif transform == "apply_availability":
        mask = jnoniid.availability_plan(1, 4, 9, 0.4)
        args = [(plan, mask), (plan[:1], mask), (plan, mask[:1])]
    elif transform == "adversary_mask":
        args = [(s, 9, f) for s in (0, 4) for f in (0.0, 0.3, 1.0)]
    elif transform == "flip_labels":
        adv = jnoniid.adversary_mask(2, 9, 0.4)
        ragged = jnoniid.quantity_skew(plan, 1, n_min=5)
        args = [(plan, adv), (ragged, adv, 10)]
    else:
        args = [(plan, s, n_min, n_max) for s in (0, 8)
                for n_min, n_max in ((5, None), (1, 12), (20, 20))]
    for a in args:
        np.testing.assert_array_equal(getattr(tnoniid, transform)(*a),
                                      getattr(jnoniid, transform)(*a))


def _scenarios(mod):
    """Every source, per-seed draws and every transform kind, stacked."""
    plan = _plan(4, 3)
    return (
        mod.ScenarioSpec.from_case("case1b", samples_per_client=16,
                                   majority=12),
        mod.ScenarioSpec.from_case(
            "iid", name="iid-avail", samples_per_client=16,
            per_seed_plans=True,
            transforms=(mod.availability(0.4, mode="mask", seed=3),
                        mod.quantity(4, 12))),
        mod.ScenarioSpec.from_bias_mix(0.5, n_min=5, n_max=20, num_rounds=2,
                                       transforms=(mod.label_flip(0.3),)),
        mod.ScenarioSpec.from_dirichlet(0.3, samples_per_client=16,
                                        transforms=(mod.availability(0.2),)),
        mod.ScenarioSpec.from_plan("explicit", plan,
                                   avail=np.ones((3, 9), np.float32)),
    )


@pytest.mark.parametrize("index", range(5))
def test_scenario_lower_bit_equal(index):
    jsc, tsc = _scenarios(jx)[index], _scenarios(tx)[index]
    cfg_j, cfg_t = _cfg(JFLConfig, num_clients=9), _cfg(FLConfig,
                                                         num_clients=9)
    want = jsc.lower(cfg_j, (0, 3), 3)
    got = tsc.lower(cfg_t, (0, 3), 3)
    assert (got.name, got.per_seed) == (want.name, want.per_seed)
    np.testing.assert_array_equal(got.plan, want.plan)
    if want.avail is None:
        assert got.avail is None
    else:
        np.testing.assert_array_equal(got.avail, want.avail)
    for r in range(2 if want.per_seed else 1):
        np.testing.assert_array_equal(got.composed_plan(r),
                                      want.composed_plan(r))
    assert tx.ScenarioSpec.from_dict(jsc.to_dict()).to_dict() == jsc.to_dict()


# ---------------------------------------------------------------------------
# Selection: the strategy that draws, and the ninth strategy
# ---------------------------------------------------------------------------

def _hists(seed, rows=12, zero=(3,)):
    g = np.random.default_rng(seed)
    h = np.stack([g.multinomial(g.integers(1, 300),
                                g.dirichlet(np.full(10, 0.4)))
                  for _ in range(rows)]).astype(np.float32)
    h[list(zero)] = 0
    h[5] = h[6]                                   # an exact tie
    return h


@pytest.mark.parametrize("name", ["random", "dirichlet_uniformity"])
@pytest.mark.parametrize("n_select", [4, 12])
def test_drawing_and_digamma_strategies_bit_equal(name, n_select):
    for seed in (0, 1, 2):
        h = _hists(seed)
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                   1002), 1)
        tk = rng.fold_in(rng.fold_in(rng.PRNGKey(seed), 1002), 1)
        fn = jsel.get_strategy(name)

        def ref_arrays(k, x):
            r = fn(k, x, n_select)
            return r.mask, r.scores, r.order

        mask, scores, order = jax.jit(ref_arrays)(jk, jnp.asarray(h))
        port = tsel.get_strategy(name)(tk, torch.from_numpy(h), n_select)
        np.testing.assert_array_equal(port.scores.numpy(), np.asarray(scores))
        np.testing.assert_array_equal(port.order.numpy(), np.asarray(order))
        np.testing.assert_array_equal(port.mask.numpy(), np.asarray(mask))
        assert port.budget == fn(jk, jnp.asarray(h), n_select).budget


def test_strategies_batched_over_trials_equal_each_trial():
    """The grid engine selects every trial in one call per strategy."""
    hs = np.stack([_hists(s) for s in range(4)])
    keys = rng.fold_in(rng.PRNGKey(torch.arange(4)), 9)
    for name in tsel.registered_strategies():
        batch = tsel.get_strategy(name)(keys, torch.from_numpy(hs), 5)
        for t in range(4):
            one = tsel.get_strategy(name)(keys[t], torch.from_numpy(hs[t]), 5)
            assert torch.equal(batch.order[t], one.order), name
            assert torch.equal(batch.mask[t], one.mask), name
            assert batch.budget == one.budget


# ---------------------------------------------------------------------------
# Specs and results as JSON
# ---------------------------------------------------------------------------

def _grid_spec(mod, cfg_cls, engine, strategies=("random", "labelwise")):
    return mod.ExperimentSpec(
        scenarios=(
            mod.ScenarioSpec.from_case("case1b", samples_per_client=SAMPLES,
                                       majority=12),
            mod.ScenarioSpec.from_case(
                "iid", name="iid-dropout", samples_per_client=SAMPLES,
                majority=12,
                transforms=(mod.availability(0.7, mode="mask"),))),
        strategies=strategies, seeds=(0, 1), engine=engine,
        fl=_cfg(cfg_cls, global_epochs=2), eval_n_per_class=2)


def test_experiment_spec_reads_reference_dict():
    ref = _grid_spec(jx, JFLConfig, "sim")
    ref = dataclasses.replace(ref, aggregation="fedsgd", rounds=2,
                              adversary={"frac": 0.2, "seed": 4})
    d = json.loads(json.dumps(ref.to_dict()))
    port = tx.ExperimentSpec.from_dict(d)
    assert port.to_dict() == ref.to_dict()
    port.validate()
    np.testing.assert_array_equal(port.adversary_masks(),
                                  ref.adversary_masks())
    assert tx.ExperimentSpec.from_dict(port.to_dict()).to_dict() == d


@pytest.fixture(scope="module")
def grid_runs():
    """Reference and port ``run(spec)`` through both engines."""
    jds, tds = JImageDataset(image_size=HW), ImageDataset(image_size=HW,
                                                          device="cpu")
    out = {}
    for engine in ("sim", "host"):
        ref_spec = _grid_spec(jx, JFLConfig, engine)
        out[("ref", engine)] = jx.run(ref_spec, ds=jds)
        port_spec = tx.ExperimentSpec.from_dict(ref_spec.to_dict())
        out[("port", engine)] = tx.run(port_spec, ds=tds, device="cpu")
    return out


@pytest.mark.parametrize("engine", ["sim", "host"])
def test_run_spec_matches_reference(grid_runs, engine):
    port, ref = grid_runs[("port", engine)], grid_runs[("ref", engine)]
    assert (port.scenarios, port.strategies, port.seeds) == (
        ref.scenarios, ref.strategies, ref.seeds)
    assert port.accuracy.shape == ref.accuracy.shape == (2, 2, 2, 2)
    _assert_trajectories(port, ref)
    # the dropout scenario really drops clients in some round
    assert ref.num_selected[1].min() < ref.num_selected[0].max()


def test_sim_per_trial_equals_port_host(grid_runs):
    _assert_trajectories(grid_runs[("port", "sim")],
                         grid_runs[("port", "host")])


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_experiment_result_json_loads_across(grid_runs, direction):
    src = grid_runs[("port" if direction == "port-to-ref" else "ref", "sim")]
    dst = jx if direction == "port-to-ref" else tx
    back = dst.ExperimentResult.from_json(src.to_json())
    for name in ("accuracy", "loss", "num_selected"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(src, name))
    assert (back.scenarios, back.strategies, back.seeds, back.engine) == (
        src.scenarios, src.strategies, src.seeds, src.engine)
    assert back.table1() == src.table1()
    assert back.table2() == src.table2()


# ---------------------------------------------------------------------------
# Whole host-loop runs, and the grid's own properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer,aggregation", [
    ("sgd", "fedavg"), ("sgd", "fedsgd"), ("adam", "fedavg")])
def test_run_fl_host_whole_runs_match_reference(optimizer, aggregation):
    """Three rounds from the same seed: init, images and ``random``'s draws
    are the reference's, so the runs agree as wholes."""
    kw = dict(optimizer=optimizer, lr=1e-2 if optimizer == "sgd" else 1e-3)
    plan = jnoniid.case_label_plan("case1b", 2, 3, N,
                                   samples_per_client=SAMPLES, majority=12)
    ref = jrun_fl(plan, _cfg(JFLConfig, **kw), strategy="random",
                  aggregation=aggregation, eval_n_per_class=2, engine="host",
                  ds=JImageDataset(image_size=HW))
    port = run_fl_host(plan, _cfg(FLConfig, **kw), strategy="random",
                       aggregation=aggregation, eval_n_per_class=2,
                       ds=ImageDataset(image_size=HW, device="cpu"),
                       device="cpu")
    _assert_trajectories(port, ref)
    assert len(port.loss) == 3 and port.compile_s == 0.0


def test_run_fl_shim_and_chunked_grid(monkeypatch):
    """``run_fl`` through both engines gives one trajectory.  Training the
    grid in chunks of two trials, as a card short of memory would, gives
    the one pass's trajectories bit for bit: each client's training does
    not depend on the other clients of its call (eval stays one call)."""
    plan = tnoniid.case_label_plan("iid", 1, 2, N, samples_per_client=SAMPLES)
    cfg = _cfg(FLConfig, global_epochs=2)
    ds = ImageDataset(image_size=HW, device="cpu")
    hs = {e: run_fl(plan, cfg, strategy="random", engine=e, ds=ds,
                    eval_n_per_class=2, device="cpu") for e in ("sim", "host")}
    _assert_trajectories(hs["sim"], hs["host"])
    plans = np.stack([plan, tnoniid.case_label_plan("case1b", 1, 2, N,
                                                    samples_per_client=SAMPLES,
                                                    majority=12)])
    kw = dict(strategies=("random", "full"), seeds=(0, 4), ds=ds,
              eval_n_per_class=2, device="cpu")
    one = grid_arrays(plans, cfg, **kw)
    assert one.meta["trials"] == 8 and one.meta["budget"] == N
    assert one.meta["chunk_trials"] == 8
    monkeypatch.setattr(tsim, "_chunk_trials", lambda device, per, trials: 2)
    chunked = grid_arrays(plans, cfg, **kw)
    monkeypatch.undo()
    assert chunked.meta["chunk_trials"] == 2
    for name in ("num_selected", "loss", "accuracy"):
        assert np.array_equal(getattr(chunked, name), getattr(one, name)), name
    # The reference's other grid entry points, over the same engine.
    alone = simulate(plan, cfg, strategy="random", ds=ds, eval_n_per_class=2,
                     device="cpu")
    assert alone.loss.tolist() == hs["sim"].loss
    grid = run_grid(plans, cfg, **kw)
    assert np.array_equal(grid.loss, one.loss)


@pytest.mark.parametrize("optimizer,aggregation,strategy", [
    ("sgd", "fedsgd", "random"), ("sgd", "fedavg", "full"),
    ("adam", "fedsgd", "kl")])
def test_grid_trial_equals_host_loop(optimizer, aggregation, strategy):
    """One trial through the grid engine against the host loop, for the
    FedSGD path (each client's gradient at its own trial's params) and the
    widest budget."""
    cfg = _cfg(FLConfig, optimizer=optimizer, lr=1e-2)
    plan = tnoniid.case_label_plan("case1b", 1, 3, N,
                                   samples_per_client=SAMPLES, majority=12)
    ds = ImageDataset(image_size=HW, device="cpu")
    runs = [run_fl(plan, cfg, strategy=strategy, aggregation=aggregation,
                   engine=e, ds=ds, eval_n_per_class=2, device="cpu")
            for e in ("sim", "host")]
    _assert_trajectories(*runs)


def test_weighted_agg_trial_axis_plain_equals_one_trial_calls():
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal((5, 7, 33)).astype(np.float32))
    w = torch.from_numpy(g.uniform(0, 3, (5, 7)).astype(np.float32))
    d = w.sum(-1)
    both = weighted_agg_ref(x, w, d)
    for t in range(5):
        assert torch.equal(both[t], weighted_agg_ref(x[t], w[t], d[t]))
    tree = {"a": x.reshape(5, 7, 3, 11), "b": x[..., :4].bfloat16()}
    mask = (w > 1).float()
    for backend in ("auto", "reference"):
        got = dispatch.masked_weighted_mean(tree, mask, w, backend=backend)
        summed = dispatch.weighted_sum_tree(tree, w, backend=backend)
        for t in range(5):
            one = dispatch.masked_weighted_mean(
                {k: v[t] for k, v in tree.items()}, mask[t], w[t],
                backend=backend)
            one_sum = dispatch.weighted_sum_tree(
                {k: v[t] for k, v in tree.items()}, w[t], backend=backend)
            for k in tree:
                assert torch.equal(got[k][t], one[k])
                assert torch.equal(summed[k][t], one_sum[k])


# ---------------------------------------------------------------------------
# What the port does not run yet raises and names its ROADMAP item
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change,item", [
    (dict(engine="sharded"), "item 12"),
    (dict(engine="hier"), "item 13"),
    (dict(engine="async"), "item 13"),
    ("deep", "item 16"),
])
def test_unported_options_raise_with_their_roadmap_item(change, item):
    """Item 16 still raises, naming its item.  Items 12 and 13's engines
    have landed: they run this grid spec (both scenarios, strategies and
    seeds) and report their ``meta["sharded"]`` or ``meta["population"]``;
    their parity with the reference is tests/test_torch_sharded.py's and
    tests/test_torch_population.py's."""
    spec = _grid_spec(tx, FLConfig, "sim")
    ds = ImageDataset(image_size=HW, device="cpu")
    if item in ("item 12", "item 13"):
        res = tx.run(dataclasses.replace(spec, **change), device="cpu", ds=ds)
        if item == "item 12":
            st = res.meta["sharded"]
            assert (st["groups"], st["clients"], st["exchange"]) == (
                1, N, "a2a")
            assert {s: f["budget"] for s, f in st["strategies"].items()} == {
                "random": PER_ROUND, "labelwise": PER_ROUND}
        else:
            assert res.meta["population"]["mode"] == change["engine"]
        assert res.accuracy.shape == (2, 2, 2, 2)
        assert np.isfinite(res.loss).all()
        return
    with pytest.raises(NotImplementedError, match=item):
        if change == "deep":
            spec.validate(deep=True)
        else:
            tx.run(dataclasses.replace(spec, **change), device="cpu", ds=ds)


def test_momentum_runs_on_every_engine():
    """``FLConfig(optimizer="momentum")`` through ``run`` on each engine
    (the optimizer's updates are held to the reference's in
    tests/test_torch_model.py): ``host`` against ``sim`` at this file's
    pins, ``sharded`` at the reference's own sharded ≡ sim pin (rtol 2e-4,
    atol 2e-5), both with selections bit-equal; ``hier`` and ``async``,
    block engines with trajectories of their own, finite."""
    ds = ImageDataset(image_size=HW, device="cpu")
    grid = _grid_spec(tx, FLConfig, "sim")
    spec = dataclasses.replace(grid, scenarios=grid.scenarios[:1],
                               seeds=grid.seeds[:1], rounds=2,
                               fl=_cfg(FLConfig, optimizer="momentum"))
    res = {e: tx.run(dataclasses.replace(spec, engine=e), device="cpu",
                     ds=ds) for e in ("sim", "host", "sharded")}
    _assert_trajectories(res["host"], res["sim"])
    np.testing.assert_array_equal(res["sharded"].num_selected,
                                  res["sim"].num_selected)
    np.testing.assert_allclose(res["sharded"].loss, res["sim"].loss,
                               rtol=2e-4, atol=2e-5)
    for e in ("hier", "async"):
        got = tx.run(dataclasses.replace(spec, engine=e,
                                         strategies=("full",)),
                     device="cpu", ds=ds)
        assert np.isfinite(got.loss).all(), e
