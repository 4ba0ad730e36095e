"""The port's clustered FL against the reference's, on the CPU: the k-means
over label histograms, the clustering helpers, the clustered round, and
whole ``clustered_fedavg``/``clustered_fedsgd`` runs through ``run(spec)``
on the ``sim`` and ``host`` engines.

Tolerances:

* k-means assignments and centroids, ``cluster_counts``, the area helpers,
  selections and ``num_selected`` are bit-equal: the port copies the
  reference's CPU rounding (FMA chains for the distances, XLA's folded
  ``linspace`` for the seed ranks, XLA's CPU dot order for the centroid
  sums), and the counts are exact.  ``cluster_assign`` of whole runs is
  bit-equal too.
* The clustered round's params: rtol 1e-5 / atol 1e-6, as
  ``tests/test_torch_round.py`` holds the one-model round (the two stacks
  sum convolutions in other orders).
* Whole runs (6 clients, 3 a round, 12×12 images, Adam): measured
  port ≡ reference within 6.7e-7 relative in loss (sim and host) and equal
  accuracy; port sim ≡ port host within 4e-7.  Loss is held to
  ``LOSS_RTOL = 5e-6``, tightened from ``tests/test_torch_experiment.py``'s
  5e-5 to about 7× the measured gap; accuracy to ``ACC_ATOL = 1e-6``
  (float32 rounding of the same count of eval samples, one sample being
  1/20 here).  Per-cluster trajectories are held to the same limits.
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
from repro.core import clustering as jclust  # noqa: E402
from repro.core import noniid as jnoniid  # noqa: E402
from repro.data import client_batches as jclient_batches  # noqa: E402
from repro.data.synthetic import ImageDataset as JImageDataset  # noqa: E402
from repro.fl.round import make_fl_round as jmake_fl_round  # noqa: E402
from repro.fl.round import stack_global_params as jstack  # noqa: E402
from repro.models.cnn import cnn_init as jcnn_init  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402

import repro_torch.fl.experiment as tx  # noqa: E402
from repro_torch.configs import FLConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import clustering as tclust  # noqa: E402
from repro_torch.data import ImageDataset, client_batches  # noqa: E402
from repro_torch.fl import make_fl_round, run_fl, run_fl_host  # noqa: E402
from repro_torch.kernels.dispatch import client_histograms  # noqa: E402
from repro_torch.models import cnn_loss  # noqa: E402

LOSS_RTOL = 5e-6
ACC_ATOL = 1e-6
C, HW = 10, 12
N, PER_ROUND, SAMPLES = 6, 3, 16
CLUSTERS = (1, 2, 4, 8)


def _round_hists(case, seed, t=0, n=100):
    """Round t's (n, C) histograms of a case plan (the paper's N = 100)."""
    plan = jnoniid.case_label_plan(case, seed, 2, n)[t]
    return np.stack([np.bincount(r[r >= 0], minlength=C)
                     for r in plan]).astype(np.float32)


def _duplicated(seed):
    """A plan with many duplicate histograms and two empty clients: exact
    distance ties and seeds that are the same pdf."""
    h = _round_hists("case3b", seed)
    h[10:40] = h[5]
    h[50:60] = h[41]
    h[[3, 77]] = 0
    return h


HIST_SETS = {**{c: _round_hists(c, 0) for c in jnoniid.CASES},
             "duplicates": _duplicated(1)}


def _ref_kmeans(h, m):
    a, c = jax.jit(lambda x: jclust.kmeans_cluster(x, m))(jnp.asarray(h))
    return np.array(a), np.array(c)


# ---------------------------------------------------------------------------
# k-means and the clustering helpers
# ---------------------------------------------------------------------------

def test_seed_positions_match_reference_linspace():
    for n in (1, 2, 6, 10, 15, 22, 100, 290):
        for m in range(1, 17):
            want = np.asarray(jax.jit(lambda: jnp.round(
                jnp.linspace(0, n - 1, m)).astype(jnp.int32))())
            assert tclust.seed_positions(n, m) == want.tolist(), (n, m)


@pytest.mark.parametrize("name", sorted(HIST_SETS))
def test_kmeans_bit_equal(name):
    h = HIST_SETS[name]
    for m in CLUSTERS:
        ra, rc = _ref_kmeans(h, m)
        ta, tc = tclust.kmeans_cluster(torch.from_numpy(h), m)
        assert ta.dtype == torch.int32
        np.testing.assert_array_equal(ta.numpy(), ra, err_msg=f"M={m}")
        np.testing.assert_array_equal(tc.numpy(), rc, err_msg=f"M={m}")


def test_kmeans_over_trials_bit_equal_to_vmapped_reference():
    hs = np.stack(list(HIST_SETS.values()))
    for m in (2, 4, 8):
        ra, rc = jax.jit(jax.vmap(lambda x: jclust.kmeans_cluster(x, m)))(
            jnp.asarray(hs))
        ta, tc = tclust.kmeans_cluster(torch.from_numpy(hs), m)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))


@pytest.mark.parametrize("n", [5, 6, 7, 9, 12, 14, 30])
def test_kmeans_small_populations_bit_equal(n):
    """Client counts on both sides of the dot order's switch (left to right
    at 5, 6 and 9; four strided lanes at 7, 12, 14 and 30), with iters 1
    and 4."""
    h = _round_hists("case2b", n, n=n)
    h[1] = h[2]
    for m in (2, 3):
        for iters in (1, 4):
            ra, rc = jax.jit(lambda x: jclust.kmeans_cluster(
                x, m, n_iters=iters))(jnp.asarray(h))
            ta, tc = tclust.kmeans_cluster(torch.from_numpy(h), m,
                                           n_iters=iters)
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))


@pytest.mark.parametrize("name", sorted(HIST_SETS))
def test_cluster_counts_and_area_helpers_bit_equal(name):
    h = HIST_SETS[name]
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    valid = (h.sum(-1) > 0).astype(np.float32)
    for m in (2, 4, 8):
        ra, _ = _ref_kmeans(h, m)
        for w in (None, valid):
            want = jclust.cluster_counts(jnp.asarray(ra), m,
                                         None if w is None else jnp.asarray(w))
            got = tclust.cluster_counts(torch.from_numpy(ra), m,
                                        None if w is None
                                        else torch.from_numpy(w))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pairs = [(tclust.cluster_membership(th), jclust.cluster_membership(jh)),
             (tclust.cluster_sizes(th), jclust.cluster_sizes(jh)),
             (tclust.area_index(th), jclust.area_index(jh)),
             (tclust.area_counts(th, C), jclust.area_counts(jh, C)),
             (tclust.greedy_area_selection(th, 30),
              jclust.greedy_area_selection(jh, 30))]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for tau in range(12):
        assert int(tclust.num_areas_upper_bound(tau)) == int(
            jclust.num_areas_upper_bound(tau))


# ---------------------------------------------------------------------------
# The clustered round, on the same batches and init
# ---------------------------------------------------------------------------

def _cfg(cls, **kw):
    base = dict(num_clients=N, clients_per_round=PER_ROUND, global_epochs=2,
                local_epochs=1, batch_size=8, lr=1e-3, optimizer="adam")
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


@pytest.mark.parametrize("aggregation", ["clustered_fedavg",
                                         "clustered_fedsgd"])
def test_clustered_round_matches_reference(aggregation):
    """Two rounds of ``make_fl_round`` in both stacks from one stacked init
    (carried over by ``params_from_jax`` with its leading cluster axis)."""
    plan = jnoniid.case_label_plan("case2b", 5, 2, N, samples_per_client=SAMPLES,
                                   majority=12)
    init = jstack(jcnn_init(jax.random.PRNGKey(1), num_classes=C,
                            image_size=HW, c1=4, c2=6, hidden=16), 2)
    jround = jmake_fl_round(lambda p, b: jcnn_loss(p, b["images"],
                                                   b["labels"], b["valid"]),
                            _cfg(JFLConfig), "labelwise", aggregation)
    tround = make_fl_round(lambda p, b: cnn_loss(p, b["images"], b["labels"],
                                                 b["valid"]),
                           _cfg(FLConfig), "labelwise", aggregation)
    jp, tp = init, params_from_jax(init, device="cpu")
    for t in range(2):
        data = _round_data(plan[t], seed=t)
        jdata = {k: jnp.asarray(v) for k, v in data.items()}
        tdata = {k: torch.from_numpy(v) for k, v in data.items()}
        jh = jnp.asarray(np.stack([np.bincount(r[r >= 0], minlength=C)
                                   for r in plan[t]]).astype(np.float32))
        th = client_histograms(torch.where(tdata["valid"], tdata["labels"], 0),
                               C, tdata["valid"])
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        jp, jinfo = jround(jp, jclient_batches(jdata, 8), jh,
                           jax.random.PRNGKey(t))
        tp, tinfo = tround(tp, client_batches(tdata, 8), th)
        for k in ("selected", "live", "mask", "num_selected", "cluster_assign",
                  "cluster_centroids", "cluster_weights"):
            np.testing.assert_array_equal(np.asarray(tinfo[k]),
                                          np.asarray(jinfo[k]), err_msg=k)
        back = params_to_jax(tp)
        for layer in jp:
            for name in jp[layer]:
                assert back[layer][name].shape[0] == 2
                np.testing.assert_allclose(back[layer][name],
                                           np.asarray(jp[layer][name]),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{layer}.{name}")


def test_cluster_without_live_clients_keeps_its_model():
    """case1a gives every client one label, so labelwise selects nobody:
    both clusters keep their params bit for bit (the per-cluster count = 0
    guard)."""
    plan = jnoniid.case_label_plan("case1a", 5, 1, N, samples_per_client=SAMPLES,
                                   majority=12)
    init = jstack(jcnn_init(jax.random.PRNGKey(1), num_classes=C,
                            image_size=HW, c1=4, c2=6, hidden=16), 2)
    tp = params_from_jax(init, device="cpu")
    tdata = {k: torch.from_numpy(v) for k, v in _round_data(plan[0], 0).items()}
    th = client_histograms(torch.where(tdata["valid"], tdata["labels"], 0), C,
                           tdata["valid"])
    new, info = make_fl_round(
        lambda p, b: cnn_loss(p, b["images"], b["labels"], b["valid"]),
        _cfg(FLConfig), "labelwise", "clustered_fedavg")(
            tp, client_batches(tdata, 8), th)
    assert float(info["num_selected"]) == 0
    for k in tp:
        assert torch.equal(new[k], tp[k])


# ---------------------------------------------------------------------------
# Whole runs through run(spec), both engines, both stacks
# ---------------------------------------------------------------------------

def _spec(mod, cfg_cls, engine, aggregation):
    return mod.ExperimentSpec(
        scenarios=(
            mod.ScenarioSpec.from_case("iid", samples_per_client=SAMPLES,
                                       majority=12),
            mod.ScenarioSpec.from_case("case2b", samples_per_client=SAMPLES,
                                       majority=12,
                                       transforms=(mod.label_flip(0.3),))),
        strategies=("labelwise",), seeds=(0, 1), engine=engine,
        fl=_cfg(cfg_cls), eval_n_per_class=2, aggregation=aggregation)


AGGREGATIONS = ("clustered_fedavg", "clustered_fedsgd")


@pytest.fixture(scope="module")
def clustered_runs():
    jds = JImageDataset(image_size=HW)
    tds = ImageDataset(image_size=HW, device="cpu")
    out = {}
    for agg in AGGREGATIONS:
        for engine in ("sim", "host"):
            ref_spec = _spec(jx, JFLConfig, engine, agg)
            out[("ref", agg, engine)] = jx.run(ref_spec, ds=jds)
            out[("port", agg, engine)] = tx.run(
                tx.ExperimentSpec.from_dict(ref_spec.to_dict()), ds=tds,
                device="cpu")
    return out


def _assert_runs_close(port, ref):
    np.testing.assert_array_equal(port.num_selected, ref.num_selected)
    np.testing.assert_allclose(port.loss, ref.loss, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(port.accuracy, ref.accuracy, rtol=0,
                               atol=ACC_ATOL)
    pc, rc = port.cluster_trajectories(), ref.cluster_trajectories()
    assert pc["n_clusters"] == rc["n_clusters"] == 2
    np.testing.assert_array_equal(pc["assign"], rc["assign"])
    np.testing.assert_allclose(pc["loss"], rc["loss"], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(pc["accuracy"], rc["accuracy"], rtol=0,
                               atol=ACC_ATOL)


@pytest.mark.parametrize("engine", ["sim", "host"])
@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_clustered_runs_match_reference(clustered_runs, aggregation, engine):
    port = clustered_runs[("port", aggregation, engine)]
    ref = clustered_runs[("ref", aggregation, engine)]
    assert port.accuracy.shape == ref.accuracy.shape == (2, 1, 2, 2)
    assert port.cluster_trajectories()["assign"].shape == (2, 1, 2, 2, N)
    _assert_runs_close(port, ref)
    # both clusters hold clients somewhere in the grid
    assign = port.cluster_trajectories()["assign"]
    assert set(np.unique(assign)) == {0, 1}


@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_clustered_grid_equals_port_host(clustered_runs, aggregation):
    _assert_runs_close(clustered_runs[("port", aggregation, "sim")],
                       clustered_runs[("port", aggregation, "host")])


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_clustered_result_json_loads_across(clustered_runs, direction):
    src = clustered_runs[("port" if direction == "port-to-ref" else "ref",
                          "clustered_fedavg", "sim")]
    dst = jx if direction == "port-to-ref" else tx
    back = dst.ExperimentResult.from_json(src.to_json())
    for name in ("accuracy", "loss", "num_selected"):
        np.testing.assert_array_equal(getattr(back, name), getattr(src, name))
    want, got = src.cluster_trajectories(), back.cluster_trajectories()
    assert got["n_clusters"] == want["n_clusters"]
    for k in ("accuracy", "loss", "assign"):
        np.testing.assert_array_equal(got[k], want[k])
    assert json.loads(back.to_json())["meta"]["clustered"] == json.loads(
        src.to_json())["meta"]["clustered"]


def test_run_fl_carries_the_cluster_detail():
    """The single-trial front ends: ``run_fl`` (both engines) and
    ``run_fl_host`` give one trajectory and one assignment history."""
    plan = jnoniid.case_label_plan("case2b", 3, 2, N, samples_per_client=SAMPLES,
                                   majority=12)
    cfg = _cfg(FLConfig)
    ds = ImageDataset(image_size=HW, device="cpu")
    runs = [run_fl(plan, cfg, strategy="random",
                   aggregation="clustered_fedavg4", engine=e, ds=ds,
                   eval_n_per_class=2, device="cpu") for e in ("sim", "host")]
    runs.append(run_fl_host(plan, cfg, strategy="random",
                            aggregation="clustered_fedavg4", ds=ds,
                            eval_n_per_class=2, device="cpu"))
    for h in runs:
        assert np.asarray(h.cluster_accuracy).shape == (2, 4)
        assert np.asarray(h.cluster_assign).shape == (2, N)
        assert h.cluster_assign == runs[0].cluster_assign
        np.testing.assert_allclose(h.loss, runs[0].loss, rtol=LOSS_RTOL)


def test_validate_rejects_behaviors_with_a_clustered_family():
    spec = _spec(tx, FLConfig, "sim", "clustered_fedavg")
    bad = dataclasses.replace(spec, adversary={"frac": 0.3,
                                               "behaviors": ["poison"]})
    with pytest.raises(ValueError, match="clustered"):
        bad.validate()
    with pytest.raises(ValueError, match="clustered"):
        jx.ExperimentSpec.from_dict(bad.to_dict()).validate()
