"""Parity of the port's sharded engine (``repro_torch.fl.sharded``, the
collectives of ``core.aggregation`` and ``run(engine="sharded")``) with the
reference on the CPU.

(a) One group: the reference runs its ``shard_map`` round on its one CPU
    device (its client axis then takes one group, as on any host with one
    device) and the port without a process group, on the same specs:
    selections, selected-label histograms and cluster assignments
    bit-equal, loss within ``LOSS_RTOL`` relative and accuracy within
    ``ACC_ATOL``, the pins of tests/test_torch_experiment.py, and
    ``meta["sharded"]`` equal.
(b) Four ``gloo`` ranks in one spawn (tests/torch_sharded_ranks.py): each
    collective against its one-process definition (bit for bit), ``a2a``
    bit-identical to ``allgather``, and ``run(engine="sharded")`` on 4
    ranks against the port's one-group run, selections bit-equal and loss
    within the reference's own sharded ≡ sim pin (rtol 2e-4, atol 2e-5,
    tests/test_experiment.py); every rank returns rank 0's result.
(c) The reference's guards (tests/test_experiment.py).

The slow tier holds four ranks against the reference's sharded engine on
four forced host devices.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import repro.fl.experiment as jx  # noqa: E402
from repro.configs.paper_cnn import FLConfig as JFLConfig  # noqa: E402
from repro.data.synthetic import ImageDataset as JImageDataset  # noqa: E402

import repro_torch.fl.experiment as tx  # noqa: E402
from repro_torch.configs import FLConfig  # noqa: E402
from repro_torch.core import Aggregator, registered_aggregators  # noqa: E402
from repro_torch.core.aggregation import (AGGREGATORS,  # noqa: E402
                                          _AGG_REGISTRY_ORDER,
                                          register_aggregator)
from repro_torch.data import ImageDataset  # noqa: E402
from repro_torch.fl import exchange_bytes_per_device  # noqa: E402
from repro_torch.fl import make_sharded_fl_round  # noqa: E402
from repro_torch.fl import topn_mask_from_scores  # noqa: E402

LOSS_RTOL = 5e-5
ACC_ATOL = 1e-6
HW = 12
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test (small tensors, several test
    processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(mod, cfg_cls, **kw):
    cfg = cfg_cls(num_clients=16, clients_per_round=4, global_epochs=2,
                  local_epochs=1, batch_size=8, lr=1e-3)
    scen = mod.ScenarioSpec.from_case(
        "case1b", samples_per_client=8,
        transforms=(mod.availability(0.3, seed=5),))
    return mod.ExperimentSpec(**{**dict(
        scenarios=(scen,), strategies=("labelwise", "full"), seeds=(0,),
        engine="sharded", fl=cfg, eval_n_per_class=2,
        telemetry=("selected_label_hist",)), **kw})


def _pair(**kw):
    ref = jx.run(_spec(jx, JFLConfig, **kw), ds=JImageDataset(image_size=HW))
    port = tx.run(_spec(tx, FLConfig, **kw), device="cpu",
                  ds=ImageDataset(image_size=HW, device="cpu"))
    return port, ref


def _assert_pair(port, ref):
    np.testing.assert_array_equal(port.num_selected, ref.num_selected)
    np.testing.assert_array_equal(
        port.telemetry()["selected_label_hist"],
        ref.telemetry()["selected_label_hist"])
    np.testing.assert_allclose(port.loss, ref.loss, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(port.accuracy, ref.accuracy, rtol=0,
                               atol=ACC_ATOL)
    assert port.meta["sharded"] == ref.meta["sharded"]


# ---------------------------------------------------------------------------
# (a) one group, port against reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"aggregation": "clustered_fedavg", "strategies": ("labelwise",)},
    {"aggregation": "median", "strategies": ("labelwise",),
     "adversary": {"frac": 0.25, "behaviors": ["poison"], "scale": -4.0}},
], ids=["fedavg", "clustered_fedavg", "median-poison"])
def test_one_group_matches_reference(kw):
    port, ref = _pair(**kw)
    _assert_pair(port, ref)
    st = port.meta["sharded"]
    assert st["groups"] == 1 and st["exchange"] == "a2a"
    assert st["reduce"] == ("gather" if "adversary" in kw else "psum")
    if "full" in port.strategies:
        assert st["strategies"]["full"]["trained_per_round"] == 16
        assert (port.num_selected[0, 1] > 4).all()
    cp, cr = port.cluster_trajectories(), ref.cluster_trajectories()
    assert (cp is None) == (cr is None)
    if cp is not None:
        assert cp["n_clusters"] == 2
        np.testing.assert_array_equal(cp["assign"], cr["assign"])
        np.testing.assert_allclose(cp["loss"], cr["loss"], rtol=LOSS_RTOL,
                                   atol=0)


@pytest.mark.parametrize("kw", [
    {"aggregation": "fedsgd"},
    {"aggregation": "clustered_fedsgd"},
    {"aggregation": "clustered_fedavg8", "telemetry": ("auto",)},
    {"aggregation": "trimmed_mean",
     "adversary": {"frac": 0.25, "behaviors": ["poison", "stale_update"],
                   "scale": -4.0, "tau": 1}},
    {"aggregation": "krum",
     "adversary": {"frac": 0.25, "behaviors": ["stale_update"], "tau": 2}},
    {"workload": "lm"},
], ids=["fedsgd", "clustered_fedsgd", "clustered_fedavg8-telemetry",
        "trimmed_mean-poison-stale", "krum-stale", "lm"])
def test_one_group_matches_sim(kw):
    """The other families, behaviors and the ``lm`` workload on one group
    against the port's ``sim`` run of the same spec: selections and
    assignments bit-equal, loss within the reference's own sharded ≡ sim
    pin (rtol 2e-4, atol 2e-5), telemetry series equal."""
    spec = _spec(tx, FLConfig, strategies=("labelwise",),
                 **({"scenarios": (tx.ScenarioSpec.from_case(
                     "iid", samples_per_client=4),),
                     "fl": FLConfig(num_clients=8, clients_per_round=3,
                                    global_epochs=2, local_epochs=1,
                                    batch_size=4, lr=1e-3),
                     "eval_n_per_class": 1, **kw}
                    if kw.get("workload") == "lm" else kw))
    ds = (None if kw.get("workload") == "lm"
          else ImageDataset(image_size=HW, device="cpu"))
    got = tx.run(spec, device="cpu", ds=ds)
    want = tx.run(dataclasses.replace(spec, engine="sim"), device="cpu",
                  ds=ds)
    np.testing.assert_array_equal(got.num_selected, want.num_selected)
    np.testing.assert_allclose(got.loss, want.loss, rtol=2e-4, atol=2e-5)
    cg, cw = got.cluster_trajectories(), want.cluster_trajectories()
    if cw is not None:
        np.testing.assert_array_equal(cg["assign"], cw["assign"])
    tg, tw = got.telemetry() or {}, want.telemetry() or {}
    for name in set(tg) & set(tw):
        np.testing.assert_allclose(tg[name], tw[name], rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    assert set(tg) <= set(tw)


def test_round_facts_and_helpers_match_reference():
    """The wrapper's static facts, ``exchange_bytes_per_device`` and
    ``topn_mask_from_scores`` against the reference's."""
    from repro.fl import sharded as js
    import jax.numpy as jnp
    from repro_torch.fl import sharded as ts
    scores = np.random.default_rng(0).integers(0, 4, 12).astype(np.float32)
    np.testing.assert_array_equal(
        topn_mask_from_scores(torch.from_numpy(scores), 5).numpy(),
        np.asarray(js.topn_mask_from_scores(jnp.asarray(scores), 5)))
    for strat, budget in (("labelwise", 6), ("full", 12), ("random", 6)):
        assert ts._static_budget(ts.get_strategy(strat), 6, 12, 10) == budget
    batch = {"images": torch.zeros((3, 2, 4, HW, HW, 1)),
             "labels": torch.zeros((3, 2, 4), dtype=torch.int32),
             "valid": torch.zeros((3, 2, 4), dtype=torch.bool)}
    jbatch = {k: jnp.zeros(v.shape, {torch.float32: jnp.float32,
                                     torch.int32: jnp.int32,
                                     torch.bool: jnp.bool_}[v.dtype])
              for k, v in batch.items()}
    for ex in ("a2a", "allgather"):
        assert exchange_bytes_per_device(batch, 16, 8, 4, ex) == \
            js.exchange_bytes_per_device(jbatch, 16, 8, 4, ex)
    fn = make_sharded_fl_round(None, None, n_select=3, num_classes=10,
                               num_clients=8, strategy="kl", mode="masked")
    assert (fn.budget, fn.budget_padded, fn.trained_per_round,
            fn.flop_sparsity, fn.mode, fn.exchange, fn.n_clusters) == (
        3, 3, 8, 0.0, "masked", None, 1)


def _micro_round_inputs(n=8, per_round=3):
    from repro_torch import rng
    from repro_torch.core import case_label_plan
    from repro_torch.data import client_batches
    from repro_torch.fl import get_workload, local_train
    from repro_torch.models import cnn_init
    from repro_torch.optim import get_optimizer
    ds = ImageDataset(image_size=HW, device="cpu")
    plan = case_label_plan("iid", 0, 1, n, samples_per_client=8, majority=6)
    labels = torch.as_tensor(plan[0], dtype=torch.int32)
    key = rng.PRNGKey(5)
    block = {"images": ds.sample(rng.fold_in(key, 0), labels),
             "labels": labels, "valid": labels >= 0}
    batches = client_batches(block, 4, ("images", "labels", "valid"))
    loss_fn = get_workload("cnn").make_loss(ds)
    opt = get_optimizer("sgd", 1e-1)

    def local_step(params, batch):
        return local_train(params, opt, batch, loss_fn, 1)[0]

    params = cnn_init(rng.PRNGKey(2), image_size=HW, device="cpu")
    return (params, batches, labels, block["valid"], rng.fold_in(key, 1),
            local_step)


def test_round_options_at_one_group():
    """The round's other branches with no process group: ``mode="masked"``
    (every client trains, the mask weighs) against ``"gather"``, a bf16
    ``agg_dtype`` against float32, and ``with_availability`` keeping dark
    clients out of the selection."""
    params, batches, labels, valid, key, step = _micro_round_inputs()
    kw = dict(n_select=3, num_classes=10, num_clients=8)
    base, info = make_sharded_fl_round(None, step, **kw)(
        params, batches, labels, valid, key)
    masked, info_m = make_sharded_fl_round(None, step, mode="masked", **kw)(
        params, batches, labels, valid, key)
    half, _ = make_sharded_fl_round(None, step, agg_dtype=torch.bfloat16,
                                    **kw)(params, batches, labels, valid, key)
    assert torch.equal(info["mask"], info_m["mask"])
    for k in params:
        scale = (base[k] - params[k]).abs().max()
        assert (masked[k] - base[k]).abs().max() <= 1e-5 * scale + 1e-7, k
        assert (half[k] - base[k]).abs().max() <= 1e-2 * scale, k
    avail = torch.ones(8)
    avail[info["mask"].nonzero()[:2, 0]] = 0.0
    _, info_a = make_sharded_fl_round(None, step, with_availability=True,
                                      **kw)(params, batches, labels, valid,
                                            key, avail)
    assert float(info_a["num_selected"]) == 3
    assert float((info_a["mask"] * (1 - avail)).sum()) == 0.0


# ---------------------------------------------------------------------------
# (b) four gloo ranks
# ---------------------------------------------------------------------------

def _ranks(out: Path, specs, world: int = 4, timeout: int = 300):
    """``specs`` (dicts) through ``run`` on ``world`` gloo ranks, after
    each rank's collective checks -> rank 0's results."""
    (out / "specs.json").write_text(json.dumps(specs))
    cmd = [sys.executable, str(ROOT / "tests" / "torch_sharded_ranks.py"),
           str(out), str(out / "specs.json"), "--world", str(world)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert all((out / f"rank{r}.ok").exists() for r in range(world))
    return [tx.ExperimentResult.from_json(p.read_text())
            for p in sorted(out.glob("result_*.json"))]


def _micro_specs():
    """16 clients in 4 blocks (``labelwise`` and ``full`` under
    availability, momentum), and 6 clients on 4 ranks, where 3 groups of 2
    take the rounds and the fourth rank only receives the result."""
    cfg = dict(num_clients=16, clients_per_round=4, global_epochs=2,
               local_epochs=1, batch_size=8, lr=1e-3)
    a = _spec(tx, FLConfig, fl=FLConfig(**cfg, optimizer="momentum"),
              telemetry=())
    b = tx.ExperimentSpec(
        scenarios=(tx.ScenarioSpec.from_case("iid", samples_per_client=8),),
        strategies=("random",), seeds=(1,), engine="sharded",
        fl=FLConfig(**{**cfg, "num_clients": 6, "clients_per_round": 3,
                       "global_epochs": 1}),
        eval_n_per_class=2)
    return [a.to_dict(), b.to_dict()]


def test_four_gloo_ranks(tmp_path):
    """Inside the spawn: the collectives, a2a ≡ allgather and the micro
    specs on 4 ranks (16 clients in blocks of 4; 6 clients on 3 of the 4
    ranks).  Here: those runs against the port's one-group runs."""
    specs = _micro_specs()
    ranked = _ranks(tmp_path, specs)
    assert len(ranked) == len(specs)
    for d, got in zip(specs, ranked):
        one = tx.run(tx.ExperimentSpec.from_dict(d), device="cpu")
        np.testing.assert_array_equal(got.num_selected, one.num_selected)
        np.testing.assert_allclose(got.loss, one.loss, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got.accuracy, one.accuracy, atol=5e-3)
        st, st1 = got.meta["sharded"], one.meta["sharded"]
        n = d["fl"]["num_clients"]
        assert (st["groups"], st1["groups"]) == ((4 if n == 16 else 3), 1)
        assert st["clients_per_group"] == n // st["groups"]
        for strat, facts in st["strategies"].items():
            assert facts["budget"] == st1["strategies"][strat]["budget"]
            assert facts["exchange_bytes_per_device"] > 0


# ---------------------------------------------------------------------------
# (c) guards
# ---------------------------------------------------------------------------

def test_guards():
    spec = _spec(tx, FLConfig, aggregation="_no_such_aggregator")
    with pytest.raises(KeyError, match="unknown aggregator"):
        tx.run(spec, device="cpu")
    before = registered_aggregators()
    register_aggregator(
        "_test_sharded_clustered_reduce",
        Aggregator(base="fedavg", n_clusters=2,
                   reduce=lambda stacked, live, sizes: stacked),
        overwrite=True)
    try:
        spec = _spec(tx, FLConfig,
                     aggregation="_test_sharded_clustered_reduce")
        with pytest.raises(ValueError, match="single-global-model"):
            tx.run(spec, device="cpu",
                   ds=ImageDataset(image_size=HW, device="cpu"))
    finally:
        AGGREGATORS.pop("_test_sharded_clustered_reduce")
        _AGG_REGISTRY_ORDER.remove("_test_sharded_clustered_reduce")
    assert registered_aggregators() == before
    for bad, match in ((dict(mode="ring"), "mode"),
                       (dict(exchange="ring"), "exchange"),
                       (dict(reduce_fn=lambda *a: a[0], n_clusters=2),
                        "single-global-model"),
                       (dict(reduce_fn=lambda *a: a[0], mode="masked"),
                        "reduce_fn")):
        kw = {"n_select": 2, "num_classes": 10, "num_clients": 8, **bad}
        with pytest.raises(ValueError, match=match):
            make_sharded_fl_round(None, None, **kw)


# ---------------------------------------------------------------------------
# Slow tier: four gloo ranks against the reference on four host devices
# ---------------------------------------------------------------------------

def _slow_specs():
    """The reference's three slow sharded tests' specs and its lm one,
    with fedsgd and krum under poison + stale_update besides."""
    cfg = JFLConfig(num_clients=16, clients_per_round=4, global_epochs=2,
                    local_epochs=1, batch_size=8, lr=1e-3)
    case = jx.ScenarioSpec.from_case("case1b", samples_per_client=8)
    base = dict(scenarios=(case,), strategies=("labelwise",), seeds=(0,),
                engine="sharded", fl=cfg, eval_n_per_class=2)
    adv = {"frac": 0.25, "behaviors": ["poison"], "scale": -4.0}
    specs = [_spec(jx, JFLConfig),
             jx.ExperimentSpec(**base, aggregation="clustered_fedavg")]
    stale = {**adv, "behaviors": ["poison", "stale_update"], "tau": 1}
    specs += [jx.ExperimentSpec(**base, aggregation=agg, adversary=a)
              for agg, a in (("trimmed_mean", adv), ("krum", {}),
                             ("median", {}), ("fedsgd", {}),
                             ("krum", stale))]
    specs.append(jx.ExperimentSpec(
        scenarios=(jx.ScenarioSpec.from_case("iid", samples_per_client=4),),
        strategies=("labelwise",), seeds=(0,), engine="sharded",
        workload="lm", fl=JFLConfig(num_clients=8, clients_per_round=3,
                                    global_epochs=2, local_epochs=1,
                                    batch_size=4, lr=1e-3),
        eval_n_per_class=1))
    return [s.to_dict() for s in specs]


@pytest.mark.slow
def test_four_ranks_match_reference_on_four_devices(tmp_path):
    """Port on 4 gloo ranks against the reference's ``sharded`` engine on
    4 forced host devices (a subprocess, as the device count must be set
    before JAX starts): selections, selected-label histograms and cluster
    assignments bit-equal, loss within ``LOSS_RTOL``, accuracy within
    ``ACC_ATOL``, ``meta["sharded"]`` equal but for the lm's exchange
    bytes (the port's tokens are int64, the reference's int32)."""
    specs = _slow_specs()
    (tmp_path / "specs.json").write_text(json.dumps(specs))
    script = textwrap.dedent(f"""
        import json
        from pathlib import Path
        from repro.fl import ExperimentSpec, run
        out = Path({str(tmp_path)!r})
        for i, d in enumerate(json.loads((out / "specs.json").read_text())):
            res = run(ExperimentSpec.from_dict(d))
            (out / f"ref_{{i}}.json").write_text(res.to_json())
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=900,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    ported = _ranks(port_dir, specs, timeout=900)
    for i, (d, got) in enumerate(zip(specs, ported)):
        ref = jx.ExperimentResult.from_json(
            (tmp_path / f"ref_{i}.json").read_text())
        np.testing.assert_array_equal(got.num_selected, ref.num_selected)
        np.testing.assert_allclose(got.loss, ref.loss, rtol=LOSS_RTOL,
                                   atol=0)
        np.testing.assert_allclose(got.accuracy, ref.accuracy, rtol=0,
                                   atol=ACC_ATOL)
        sp, sr = got.meta["sharded"], ref.meta["sharded"]
        assert sp["groups"] == sr["groups"] == 4
        if d["workload"] == "lm":
            for facts in (*sp["strategies"].values(),
                          *sr["strategies"].values()):
                facts.pop("exchange_bytes_per_device")
        assert sp == sr
        cp, cr = got.cluster_trajectories(), ref.cluster_trajectories()
        if cr is not None:
            np.testing.assert_array_equal(cp["assign"], cr["assign"])
        tp, tr = got.telemetry(), ref.telemetry()
        if tr is not None and "selected_label_hist" in tr:
            np.testing.assert_array_equal(tp["selected_label_hist"],
                                          tr["selected_label_hist"])
