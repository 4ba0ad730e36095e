"""The port's observability package against the reference's ``repro.obs``,
on the CPU: the metrics registry and its request rules, each builtin metric
on the same round state, telemetry off against on, the envelope and result
JSON across both packages, trace spans and the profiler hook, and the
report text.

Tolerances:

* Registry ledgers, request resolution, envelopes, result JSON and the
  report's text are equal.
* Metrics on the same NumPy-made state: ``selected_label_hist``,
  ``cluster_occupancy`` and ``staleness_hist`` are counts, bit-equal;
  ``selection_entropy``, ``update_norm``, ``centroid_drift`` and
  ``delta_outlier`` are float32 sums in another order, held to rtol 1e-5 /
  atol 1e-6 (measured ≤ 2.7e-7 relative).
* Telemetry off against on: trajectories, clustered detail and
  ``num_selected`` bit-identical, on both engines, clustered and attacked.
* Whole telemetry runs (6 clients, 3 a round, two rounds, SGD) against the
  reference's series: ``selected_label_hist`` and ``cluster_occupancy``
  bit-equal (they count selections and assignments, which are bit-equal);
  the float series within rtol 1e-5 / atol 1e-5, since they read trained
  params and update norms that differ by the training kernels' last bits
  (measured: 1.4e-6 absolute on ``delta_outlier``'s z-scores, 2.7e-7 on
  ``update_norm``; port sim ≡ port host alike).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fl.experiment as jx  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.configs.paper_cnn import FLConfig as JFLConfig  # noqa: E402
from repro.data.synthetic import ImageDataset as JImageDataset  # noqa: E402

import repro_torch.fl.experiment as tx  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.configs import FLConfig  # noqa: E402
from repro_torch.data import ImageDataset  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.obs.__main__ import main as obs_main  # noqa: E402

C, HW = 10, 12
N, PER_ROUND, SAMPLES = 6, 3, 16
BUILTINS = ("selection_entropy", "selected_label_hist", "update_norm",
            "cluster_occupancy", "centroid_drift", "staleness_hist",
            "delta_outlier")
COUNTS = ("selected_label_hist", "cluster_occupancy", "staleness_hist")


# ---------------------------------------------------------------------------
# Registry and request rules
# ---------------------------------------------------------------------------

def test_metric_ledger_matches_reference():
    assert tobs.registered_metrics()[:7] == BUILTINS
    assert jobs.registered_metrics()[:7] == BUILTINS
    for i, name in enumerate(BUILTINS):
        assert tobs.metric_id(name) == jobs.metric_id(name) == i
        tm, jm = tobs.get_metric(name), jobs.get_metric(name)
        assert (tm.requires, tm.axes) == (jm.requires, jm.axes)
    with pytest.raises(KeyError):
        tobs.get_metric("no_such_metric")


def test_register_metric_contract():
    m = tobs.get_metric("update_norm")
    tobs.register_metric("update_norm", m.fn, requires=m.requires,
                         overwrite=True)
    assert tobs.metric_id("update_norm") == 2
    with pytest.raises(ValueError):
        tobs.register_metric("update_norm", m.fn)
    # check=True: a host round trip in the body is the reference's A005 and
    # registers nothing; the clean callable registers.
    from repro_torch.analysis import ContractError
    from repro_torch.obs import registry as treg

    def host_sum(state):
        return torch.as_tensor(state["hists"].numpy().sum())

    with pytest.raises(ContractError) as ei:
        tobs.register_metric("checked", host_sum, requires=("hists",),
                             check=True, device="cpu")
    assert {d.code for d in ei.value.findings.errors()} == {"A005"}
    assert "checked" not in tobs.registered_metrics()
    try:
        tobs.register_metric("checked", m.fn, requires=m.requires,
                             check=True, device="cpu")
        assert tobs.registered_metrics()[-1] == "checked"
    finally:
        treg._METRICS.pop("checked", None)
        if "checked" in treg._METRIC_IDS:
            treg._METRIC_IDS.remove("checked")
    with pytest.raises(TypeError):
        tobs.register_metric("not_callable", 3)


@pytest.mark.parametrize("env", [None, "", "0", "off", "1", "auto", "all",
                                 "update_norm, selection_entropy"])
def test_telemetry_request_matches_reference(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("REPRO_TELEMETRY", raising=False)
    else:
        monkeypatch.setenv("REPRO_TELEMETRY", env)
    for spec in ((), ("update_norm",), ("auto",)):
        assert tobs.resolve_telemetry_request(spec) == \
            jobs.resolve_telemetry_request(spec)


@pytest.mark.parametrize("clustered", [False, True])
def test_resolved_metrics_match_reference(clustered):
    from repro_torch.fl.loop import telemetry_keys
    keys = telemetry_keys(clustered)
    for names in (("auto",), ("update_norm", "staleness_hist"),
                  ("delta_outlier", "centroid_drift")):
        got = [m.name for m in tobs.resolve_metrics(names, keys)]
        want = [m.name for m in jobs.resolve_metrics(names, keys)]
        assert got == want
    assert "staleness_hist" not in got


# ---------------------------------------------------------------------------
# Each builtin on the same round state
# ---------------------------------------------------------------------------

def _state(seed):
    g = np.random.default_rng(seed)
    hists = g.integers(0, 30, (N, C)).astype(np.float32)
    hists[2] = 0
    mask = np.zeros(N, np.float32)
    mask[[0, 3, 5]] = 1
    old = {"w": g.standard_normal((2, 4, 3)).astype(np.float32),
           "b": g.standard_normal((2, 3)).astype(np.float32)}
    new = {k: (v + 0.01 * g.standard_normal(v.shape)).astype(np.float32)
           for k, v in old.items()}
    return {
        "hists": hists, "mask": mask, "num_classes": C, "n_clusters": 2,
        "params_old": old, "params_new": new,
        "assign": g.integers(0, 2, N).astype(np.int32),
        "centroids": g.random((2, C)).astype(np.float32),
        "prev_centroids": g.random((2, C)).astype(np.float32),
        "client_update_norms": (g.random(N) * mask).astype(np.float32),
        "staleness_delays": g.integers(0, 4, 7).astype(np.int32),
        "tau_max": 3}


def _convert(state, to):
    def one(v):
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            return to(v)
        return v
    return {k: one(v) for k, v in state.items()}


@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_metric_matches_reference(name):
    for seed in range(3):
        state = _state(seed)
        want = np.asarray(jax.jit(lambda s: jobs.get_metric(name).fn(
            {**s, "num_classes": C, "n_clusters": 2, "tau_max": 3}))(
            _convert({k: v for k, v in state.items()
                      if k not in ("num_classes", "n_clusters", "tau_max")},
                     jnp.asarray)))
        got = tobs.collect_metrics([tobs.get_metric(name)],
                                   _convert(state, torch.from_numpy))[name]
        assert got.dtype == torch.float32
        if name in COUNTS:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# Whole runs with telemetry
# ---------------------------------------------------------------------------

def _cfg(cls):
    return cls(num_clients=N, clients_per_round=PER_ROUND, global_epochs=2,
               local_epochs=1, batch_size=8, lr=1e-2, optimizer="sgd")


RUNS = {
    "clustered": dict(aggregation="clustered_fedavg"),
    "attacked": dict(aggregation="krum", adversary={
        "frac": 0.34, "behaviors": ["poison"], "scale": -4.0}),
}


def _spec(mod, cfg_cls, engine, kind, telemetry):
    return mod.ExperimentSpec(
        scenarios=(mod.ScenarioSpec.from_case(
            "iid", samples_per_client=SAMPLES, majority=12),),
        strategies=("labelwise",), seeds=(0, 1), engine=engine,
        fl=_cfg(cfg_cls), eval_n_per_class=2, telemetry=telemetry,
        **RUNS[kind])


@pytest.fixture(scope="module")
def telemetry_runs():
    tds = ImageDataset(image_size=HW, device="cpu")
    jds = JImageDataset(image_size=HW)
    out = {}
    for kind in RUNS:
        for engine in ("sim", "host"):
            for tel in ((), ("auto",)):
                spec = _spec(tx, FLConfig, engine, kind, tel)
                out[("port", kind, engine, tel)] = tx.run(
                    spec, ds=tds, device="cpu")
        out[("ref", kind)] = jx.run(jx.ExperimentSpec.from_dict(
            _spec(tx, FLConfig, "sim", kind, ("auto",)).to_dict()), ds=jds)
    return out


@pytest.mark.parametrize("engine", ["sim", "host"])
@pytest.mark.parametrize("kind", sorted(RUNS))
def test_telemetry_off_is_bit_identical_to_on(telemetry_runs, kind, engine):
    off = telemetry_runs[("port", kind, engine, ())]
    on = telemetry_runs[("port", kind, engine, ("auto",))]
    for name in ("accuracy", "loss", "num_selected"):
        assert np.array_equal(getattr(off, name), getattr(on, name)), name
    if kind == "clustered":
        a, b = off.cluster_trajectories(), on.cluster_trajectories()
        for k in ("accuracy", "loss", "assign"):
            assert np.array_equal(a[k], b[k]), k
    assert off.telemetry() is None
    series = on.telemetry()
    want = ({"selection_entropy", "selected_label_hist", "update_norm",
             "cluster_occupancy", "centroid_drift"} if kind == "clustered"
            else {"selection_entropy", "selected_label_hist", "update_norm",
                  "delta_outlier"})
    assert set(series) == want
    for name, arr in series.items():
        assert arr.shape[:4] == (1, 1, 2, 2), name
        assert np.isfinite(arr).all(), name


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_telemetry_grid_equals_port_host(telemetry_runs, kind):
    sim = telemetry_runs[("port", kind, "sim", ("auto",))].telemetry()
    host = telemetry_runs[("port", kind, "host", ("auto",))].telemetry()
    for name in sim:
        if name in COUNTS:
            np.testing.assert_array_equal(sim[name], host[name])
        else:
            np.testing.assert_allclose(sim[name], host[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_telemetry_series_match_reference(telemetry_runs, kind):
    port = telemetry_runs[("port", kind, "sim", ("auto",))].telemetry()
    ref = telemetry_runs[("ref", kind)].telemetry()
    assert set(port) == set(ref)
    for name in ref:
        assert port[name].shape == ref[name].shape, name
        if name in COUNTS:
            np.testing.assert_array_equal(port[name], ref[name])
        else:
            np.testing.assert_allclose(port[name], ref[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    if kind == "attacked":
        # the byzantine fingerprint: a poisoned client stands out
        assert np.abs(port["delta_outlier"]).max() > 1.0


# ---------------------------------------------------------------------------
# The envelope, result JSON and the report across both packages
# ---------------------------------------------------------------------------

def test_envelope_builds_alike():
    g = np.random.default_rng(0)
    series = {"selection_entropy": g.random((1, 2, 2, 3)).astype(np.float32),
              "cluster_occupancy": g.integers(0, 5, (1, 2, 2, 3, 2)).astype(
                  np.float32),
              "custom_series": g.random((1, 2, 2, 3, 4)).astype(np.float32)}
    kw = dict(series=series, engine_facts={"clustered": {"n_clusters": 2}},
              spans={"validate": {"count": 1, "total_s": 0.5}},
              memory_analysis=[{"label": "sim:grid",
                                "peak_bytes_allocated": 123}])
    port = tobs.build_envelope("sim", **kw)
    ref = jobs.build_envelope("sim", **kw)
    assert json.loads(json.dumps(port)) == json.loads(json.dumps(ref))
    assert port["version"] == tobs.TELEMETRY_SCHEMA_VERSION == 1
    for name, arr in tobs.series_arrays(json.loads(json.dumps(ref))).items():
        np.testing.assert_array_equal(arr, series[name])


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_telemetry_result_json_loads_across(telemetry_runs, direction):
    src = (telemetry_runs[("port", "attacked", "sim", ("auto",))]
           if direction == "port-to-ref" else
           telemetry_runs[("ref", "attacked")])
    dst = jx if direction == "port-to-ref" else tx
    back = dst.ExperimentResult.from_json(src.to_json())
    want, got = src.telemetry(), back.telemetry()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    env = back.meta["telemetry"]
    assert env["version"] == 1 and env["axes"] == list(tobs.BASE_AXES)
    assert "validate" in env["spans"]


@pytest.mark.parametrize("source", ["port-clustered", "port-attacked",
                                    "ref-attacked", "no-telemetry"])
def test_report_text_equals_reference(telemetry_runs, source, tmp_path,
                                      capsys):
    if source == "no-telemetry":
        res = telemetry_runs[("port", "clustered", "host", ())]
    elif source.startswith("port"):
        res = telemetry_runs[("port", source.split("-")[1], "sim",
                              ("auto",))]
    else:
        res = telemetry_runs[("ref", "attacked")]
    doc = json.loads(res.to_json())
    text = tobs.render_report(doc)
    assert text == jobs.render_report(doc)
    assert tobs.health_flags(doc["meta"]["telemetry"],
                             np.asarray(doc["loss"])) == jobs.health_flags(
        doc["meta"]["telemetry"], np.asarray(doc["loss"]))
    path = tmp_path / "result.json"
    path.write_text(res.to_json())
    assert obs_main(["report", str(path)]) == 0
    assert capsys.readouterr().out.strip() == text


def test_report_flags_a_starved_cluster():
    env = tobs.build_envelope("sim", series={
        "cluster_occupancy": np.array([[[[[3.0, 0.0], [2.0, 0.0]]]]])})
    flags = tobs.health_flags(env)
    assert flags == jobs.health_flags(env)
    assert any("cluster starvation: cluster 1" in f for f in flags)


# ---------------------------------------------------------------------------
# Spans, the Chrome trace and the profiler hook
# ---------------------------------------------------------------------------

def test_spans_summarize_and_write_chrome_json(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TRACE_DIR", raising=False)
    assert ttrace.write_trace() is None
    with tobs.span("stage_a", engine="sim") as s:
        pass
    tobs.instant("marker")
    tobs.record_duration("engine_wall:sim", 0.25)
    summary = tobs.span_summary()
    assert summary["stage_a"]["count"] >= 1 and s.duration_s >= 0
    assert summary["engine_wall:sim"]["total_s"] >= 0.25
    path = ttrace.write_trace(str(tmp_path / "t.json"))
    doc = json.loads(open(path).read())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"stage_a", "marker", "engine_wall:sim"} <= names
    assert all(e["ph"] in ("X", "i") for e in doc["traceEvents"])


def test_trace_dir_runs_the_engine_under_torch_profiler(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    spec = tx.ExperimentSpec(
        scenarios=(tx.ScenarioSpec.from_case("iid", samples_per_client=8,
                                             majority=6),),
        strategies=("random",), seeds=(0,), engine="sim",
        fl=FLConfig(num_clients=4, clients_per_round=2, global_epochs=1,
                    local_epochs=1, batch_size=8), eval_n_per_class=1)
    res = tx.run(spec, ds=ImageDataset(image_size=HW, device="cpu"),
                 device="cpu")
    files = sorted(p.name for p in tmp_path.rglob("*.json"))
    assert any(f.startswith("trace_") for f in files)
    prof = list((tmp_path / "torch").glob("sim_*.json"))
    assert prof, files
    names = {e.get("name") for e in json.loads(prof[0].read_text())[
        "traceEvents"]}
    assert {"grid/train", "grid/aggregate"} <= names
    assert "engine_execute:sim" in res.meta["telemetry"]["spans"]
    # a CPU run has no device memory to report
    assert "memory_analysis" not in res.meta["telemetry"]
