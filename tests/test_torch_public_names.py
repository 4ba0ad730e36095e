"""The reference's public names in the port, on the CPU.

Each package of the port exports the names its counterpart in ``repro``
exports, apart from the ones that ROADMAP.md lists as left out
(``MESH_ONLY``).  The names that compute something are
held to the reference on the same NumPy-made inputs: counts and integer
statistics bit-equal; the weighted means within float32 rounding (rtol and
atol 1e-6: one rounding a term, summed in another order), as
tests/test_torch_kernels.py holds the weighted sums.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import label_stats as jstats  # noqa: E402
from repro.fl import experiment as jexp  # noqa: E402
from repro.fl import loop as jloop  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels.weighted_agg import ops as jops  # noqa: E402
from repro.obs import registry as jregistry  # noqa: E402

from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import label_stats as tstats  # noqa: E402
from repro_torch.fl import experiment as texp  # noqa: E402
from repro_torch.fl import loop as tloop  # noqa: E402
from repro_torch.kernels import dispatch as tdispatch  # noqa: E402
from repro_torch.kernels.weighted_agg import ops as tops  # noqa: E402
from repro_torch.obs import registry as tregistry  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

# Exported by the reference and left out of the port (ROADMAP.md, Queue 1,
# "Left out").
MESH_ONLY = {
    "fl": {"make_trial_fn"},        # the port's GridRun carries a trial axis
}
PACKAGES = ("kernels", "core", "fl", "models", "configs", "obs")
# Module-level names of the reference's modules that the port's mirrors
# carry, beside the package exports.
MODULE_NAMES = [
    ("core.label_stats", "expected_coverage_per_round"),
    ("core.aggregation", "fedavg_aggregate"),
    ("core.aggregation", "fedsgd_aggregate"),
    ("core.aggregation", "BUILTIN_AGGREGATORS"),
    ("kernels.label_hist.ops", "client_statistics"),
    ("kernels.weighted_agg.ops", "aggregate_params"),
    ("kernels.weighted_agg.ops", "normalized_scales"),
    ("kernels.dispatch", "compute_backend"),
    ("fl.experiment", "engine_option_keys"),
    ("fl.loop", "success_rate"),
    ("obs.registry", "metrics_registry"),
    ("obs.trace", "reset"),
    ("configs", "all_configs"),
]


def _public(mod):
    return set(getattr(mod, "__all__", None)
               or (n for n in dir(mod) if not n.startswith("_")))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_the_references_names(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = _public(ref) - _public(port)
    assert missing == MESH_ONLY.get(pkg, set()), sorted(missing)
    for name in _public(ref) - missing:
        assert hasattr(port, name), name
        assert callable(getattr(ref, name)) == callable(getattr(port, name)), \
            name


@pytest.mark.parametrize("module,name", MODULE_NAMES,
                         ids=[f"{m}.{n}" for m, n in MODULE_NAMES])
def test_module_carries_the_references_name(module, name):
    ref = getattr(importlib.import_module(f"repro.{module}"), name)
    port = getattr(importlib.import_module(f"repro_torch.{module}"), name)
    assert callable(ref) == callable(port)


def test_expected_coverage_per_round_bit_equal():
    rng = np.random.default_rng(0)
    hists = (rng.random((3, 7, 10)) < 0.15).astype(np.float32) * 4
    want = np.asarray(jstats.expected_coverage_per_round(jnp.asarray(hists)))
    got = tstats.expected_coverage_per_round(torch.from_numpy(hists))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tstats.expected_coverage_per_round(torch.from_numpy(hists[0])).numpy(),
        want[0])


def _stack(seed, k=6):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((k, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((k, 4)).astype(np.float32)}


@pytest.mark.parametrize("fn", ["fedavg_aggregate", "fedsgd_aggregate"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fedavg_and_fedsgd_aggregate_match(fn, weighted):
    stack = _stack(1)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    n = (np.arange(6, dtype=np.float32) * 7 + 3) if weighted else None
    want = getattr(jagg, fn)({k: jnp.asarray(v) for k, v in stack.items()},
                             jnp.asarray(mask),
                             None if n is None else jnp.asarray(n))
    got = getattr(tagg, fn)({k: torch.from_numpy(v) for k, v in stack.items()},
                            torch.from_numpy(mask),
                            None if n is None else torch.from_numpy(n))
    for k in stack:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def test_builtin_aggregators_and_strategies_equal_the_references():
    from repro.core import BUILTIN_STRATEGIES as JSTRATS
    from repro_torch.core import BUILTIN_STRATEGIES
    import repro.fl as jfl
    import repro_torch.fl as tfl
    assert tagg.BUILTIN_AGGREGATORS == jagg.BUILTIN_AGGREGATORS
    assert BUILTIN_STRATEGIES == JSTRATS
    n = len(JSTRATS)
    assert tfl.ENGINE_STRATEGIES[:n] == jfl.ENGINE_STRATEGIES[:n]
    assert tfl.ENGINE_STRATEGIES == tfl.registered_strategies()


def test_normalized_scales_and_aggregate_params_match():
    stack = _stack(2)
    rng = np.random.default_rng(3)
    weights = rng.uniform(30, 290, 6).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    np.testing.assert_allclose(
        tops.normalized_scales(torch.from_numpy(weights),
                               torch.from_numpy(mask)).numpy(),
        np.asarray(jops.normalized_scales(jnp.asarray(weights),
                                          jnp.asarray(mask))),
        rtol=1e-6, atol=1e-7)
    want = jops.aggregate_params({k: jnp.asarray(v) for k, v in stack.items()},
                                 jnp.asarray(weights), jnp.asarray(mask),
                                 interpret=True)
    got = tops.aggregate_params({k: torch.from_numpy(v)
                                 for k, v in stack.items()},
                                torch.from_numpy(weights),
                                torch.from_numpy(mask))
    for k in stack:
        assert got[k].shape == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def test_aggregate_params_keeps_bfloat16_leaves():
    stack = _stack(4)
    w, mask = torch.ones(6), torch.ones(6)
    got = tops.aggregate_params(
        {k: torch.from_numpy(v).bfloat16() for k, v in stack.items()}, w, mask)
    assert all(v.dtype == torch.bfloat16 for v in got.values())


def test_success_rate_matches():
    finals = [0.1, 0.35, 0.2, 0.9, 0.21]
    want = jloop.success_rate([jloop.FLHistory([0.0, a], [1.0, 1.0],
                                               [3.0, 3.0], 0.0)
                               for a in finals])
    got = tloop.success_rate([tloop.FLHistory([0.0, a], [1.0, 1.0],
                                              [3.0, 3.0], 0.0)
                              for a in finals])
    assert got == want == 0.6
    assert tloop.success_rate(
        [tloop.FLHistory([a], [1.0], [3.0], 0.0) for a in finals], 0.3) \
        == jloop.success_rate(
            [jloop.FLHistory([a], [1.0], [3.0], 0.0) for a in finals], 0.3)


def test_engine_option_keys_match():
    for name in jexp.engines():
        assert texp.engine_option_keys(name) == jexp.engine_option_keys(name)
    with pytest.raises(KeyError):
        texp.engine_option_keys("no-such-engine")


def test_compute_backend_resolves_as_the_dispatch(monkeypatch):
    """The names both sides take resolve alike; the reference's TPU names
    raise in the port, and an unset variable leaves the device to decide
    there ("auto") where the reference picks its platform's backend."""
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)
    assert tdispatch.compute_backend() == "auto"
    for value in ("reference",):
        monkeypatch.setenv(tdispatch.ENV_VAR, value)
        assert tdispatch.compute_backend() == jdispatch.compute_backend() \
            == value
    monkeypatch.setenv(tdispatch.ENV_VAR, "bogus")
    for fn in (tdispatch.compute_backend, jdispatch.compute_backend):
        with pytest.raises(ValueError):
            fn()
    monkeypatch.delenv(tdispatch.ENV_VAR)
    assert tdispatch.compute_backend("reference") == "reference"
    with pytest.raises(ValueError):
        tdispatch.compute_backend("pallas")


# The builtin metrics, registered in this order by both registries at
# import (other test files may register more into either).
BUILTIN_METRICS = ("selection_entropy", "selected_label_hist", "update_norm",
                   "cluster_occupancy", "centroid_drift", "staleness_hist",
                   "delta_outlier")


def test_metrics_registry_configs_and_trace_reset():
    n = len(BUILTIN_METRICS)
    assert tuple(tregistry.metrics_registry())[:n] == BUILTIN_METRICS \
        == tuple(jregistry.metrics_registry())[:n]
    assert tuple(tregistry.metrics_registry()) == \
        tregistry.registered_metrics()     # a live view
    assert {a: dataclasses.asdict(c) for a, c in all_configs().items()} == \
        {a: dataclasses.asdict(c) for a, c in jall_configs().items()}
    ttrace.instant("probe")
    assert ttrace.events()
    ttrace.reset()
    assert ttrace.events() == [] and ttrace.memory_snapshots() == []
