"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``), class for class with
tests/test_analysis.py: seeded violations at ``validate(deep=True)``, the
metric contract, registration-time checks, the registry sweep, the
separability matrix, the repo lint and the CLI.

Each seeded-violation fixture of tests/test_analysis.py has a torch
counterpart here (``_t_*``); a test runs the JAX fixture through
``repro.analysis`` and the counterpart through ``repro_torch.analysis`` and
asserts that both give the same set of error codes.  Everything runs on the
CPU (``device="cpu"``) at micro size (16 clients, 4 a round).
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.analysis as jan  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.analysis.separability import \
    classify_strategy as jclassify  # noqa: E402
from repro.core.selection import SelectionResult as JSelectionResult  # noqa: E402
from repro.core.selection import STRATEGIES as JSTRATEGIES  # noqa: E402
from repro.fl.workloads import get_workload as jget_workload  # noqa: E402
from repro.obs.registry import _METRIC_IDS as J_METRIC_IDS  # noqa: E402
from repro.obs.registry import _METRICS as J_METRICS  # noqa: E402

import repro_torch.fl.experiment  # noqa: E402,F401  (registers extensions)
from repro_torch import rng  # noqa: E402
from repro_torch.analysis import (ContractError, Findings,  # noqa: E402
                                  check_metric, check_registries,
                                  classify_strategy, run_repo_checks)
from repro_torch.analysis.separability import (graph_ops,  # noqa: E402
                                               trace_graph)
from repro_torch.configs import FLConfig  # noqa: E402
from repro_torch.core.selection import (STRATEGIES, SelectionResult,  # noqa: E402
                                        _REGISTRY_ORDER, register_strategy)
from repro_torch.fl import ExperimentSpec, ScenarioSpec, run  # noqa: E402
from repro_torch.fl.workloads import (_WORKLOADS, get_workload,  # noqa: E402
                                      register_workload)
from repro_torch.obs import register_metric, registered_metrics  # noqa: E402
from repro_torch.obs.registry import _METRIC_IDS, _METRICS  # noqa: E402

MICRO16 = FLConfig(num_clients=16, clients_per_round=4, global_epochs=1,
                   local_epochs=1, batch_size=8, lr=1e-3)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _cli():
    """``python -m repro_torch.analysis --device cpu --json`` in a fresh
    interpreter (which sees only import-time registrations), started when
    the module's first test starts so that it runs beside the others;
    :class:`TestCLI` reads its result."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--json"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: these tests' tensors are small,
    and the suite runs several test processes at once, where every
    process's thread pool would compete for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _temp_strategy(name, fn):
    """Register a (possibly broken) strategy and ALWAYS unregister it."""
    register_strategy(name, fn, overwrite=True)
    try:
        yield
    finally:
        STRATEGIES.pop(name, None)
        if name in _REGISTRY_ORDER:
            _REGISTRY_ORDER.remove(name)


@contextlib.contextmanager
def _temp_workload(name, wl):
    register_workload(name, wl, overwrite=True)
    try:
        yield
    finally:
        _WORKLOADS.pop(name, None)


@contextlib.contextmanager
def _temp_metric(name, fn, jfn=None, **kw):
    """Register ``fn`` in the port's metric registry (and ``jfn``, when
    given, in the reference's) and ALWAYS unregister both."""
    register_metric(name, fn, overwrite=True, **kw)
    if jfn is not None:
        jobs.register_metric(name, jfn, overwrite=True, **kw)
    try:
        yield
    finally:
        for reg, ids in ((_METRICS, _METRIC_IDS),
                         (J_METRICS, J_METRIC_IDS)):
            reg.pop(name, None)
            if name in ids:
                ids.remove(name)


def _spec(**kw):
    base = dict(scenarios=(ScenarioSpec.from_case("iid"),),
                strategies=("labelwise",), fl=MICRO16)
    base.update(kw)
    return ExperimentSpec(**base)


def _errors(findings):
    return sorted({d.code for d in findings if d.severity == "error"})


def _deep_codes(spec):
    """The error codes ``validate(deep=True)`` raises for ``spec``."""
    with pytest.raises(ContractError) as ei:
        spec.validate(deep=True, device="cpu")
    return _errors(ei.value.diagnostics), ei.value


def _jstrategy_codes(fn):
    """The reference's error codes for a JAX strategy at MICRO16's
    shapes (what its ``validate(deep=True)`` checks a strategy at)."""
    return _errors(jan.check_strategy("_j", fn, num_clients=16,
                                      num_classes=10, n_select=4,
                                      separability=False))


# ---------------------------------------------------------------------------
# Deliberately broken registry entries: the reference's fixtures (JAX) and
# their counterparts (torch)
# ---------------------------------------------------------------------------

def _j_bad_dtype_strategy(key, hists, n_select=None):
    del key
    scores = hists.sum(-1)
    return JSelectionResult(mask=(scores > 0).astype(jnp.int32),
                            scores=scores,
                            order=jnp.argsort(-scores).astype(jnp.float32),
                            budget=n_select)


def _t_bad_dtype_strategy(key, hists, n_select=None):
    """SelectionResult schema violation: mask is int32, order is float32."""
    del key
    scores = hists.sum(-1)
    return SelectionResult(mask=(scores > 0).to(torch.int32), scores=scores,
                           order=torch.argsort(-scores).to(torch.float32),
                           budget=n_select)


def _j_traced_bool_strategy(key, hists, n_select=None):
    del key
    scores = hists.sum(-1)
    if scores.sum() > 0:
        scores = scores / scores.sum()
    mask = (scores > 0).astype(jnp.float32)
    order = jnp.argsort(-scores).astype(jnp.int32)
    return JSelectionResult(mask=mask, scores=scores, order=order,
                            budget=n_select)


def _t_traced_bool_strategy(key, hists, n_select=None):
    """Data-dependent control flow: branches on a traced truth value."""
    del key
    scores = hists.sum(-1)
    if scores.sum() > 0:
        scores = scores / scores.sum()
    mask = (scores > 0).to(torch.float32)
    order = torch.argsort(-scores).to(torch.int32)
    return SelectionResult(mask=mask, scores=scores, order=order,
                           budget=n_select)


def _j_traced_budget_strategy(key, hists, n_select=None):
    del key
    scores = hists.sum(-1)
    mask = (scores > 0).astype(jnp.float32)
    order = jnp.argsort(-scores).astype(jnp.int32)
    return JSelectionResult(mask=mask, scores=scores, order=order,
                            budget=jnp.int32(4 if n_select is None
                                             else n_select))


def _t_traced_budget_strategy(key, hists, n_select=None):
    """Budget must be a static Python int, not a 0-d tensor."""
    del key
    scores = hists.sum(-1)
    mask = (scores > 0).to(torch.float32)
    order = torch.argsort(-scores).to(torch.int32)
    return SelectionResult(mask=mask, scores=scores, order=order,
                           budget=torch.tensor(4 if n_select is None
                                               else n_select))


def _j_const_seeded_strategy(key, hists, n_select=None):
    del key
    k = jax.random.PRNGKey(0)
    scores = jax.random.uniform(k, (hists.shape[0],))
    mask = jnp.ones((hists.shape[0],), jnp.float32)
    order = jnp.argsort(-scores).astype(jnp.int32)
    return JSelectionResult(mask=mask, scores=scores, order=order,
                            budget=n_select)


def _t_const_seeded_strategy(key, hists, n_select=None):
    """Ignores the engine's key and builds a constant-seeded stream."""
    del key
    k = rng.PRNGKey(0, hists.device)
    scores = rng.uniform(k, (hists.shape[0],))
    mask = torch.ones((hists.shape[0],), dtype=torch.float32,
                      device=hists.device)
    order = torch.argsort(-scores).to(torch.int32)
    return SelectionResult(mask=mask, scores=scores, order=order,
                           budget=n_select)


def _j_nonsep_strategy(key, hists, n_select=None):
    del key
    total = hists.sum()
    scores = hists.sum(-1) / (total + 1.0)
    mask = (scores > 0).astype(jnp.float32)
    order = jnp.argsort(-scores).astype(jnp.int32)
    return JSelectionResult(mask=mask, scores=scores, order=order,
                            budget=n_select)


def _t_nonsep_strategy(key, hists, n_select=None):
    """Row scores normalized by a population-wide total — NOT separable."""
    del key
    total = hists.sum()           # client-axis reduction
    scores = hists.sum(-1) / (total + 1.0)
    mask = (scores > 0).to(torch.float32)
    order = torch.argsort(-scores).to(torch.int32)
    return SelectionResult(mask=mask, scores=scores, order=order,
                           budget=n_select)


def _j_callback_metric(state):
    return jax.pure_callback(
        lambda h: h.sum(), jax.ShapeDtypeStruct((), jnp.float32),
        state["hists"])


def _t_callback_metric(state):
    """A host round trip inside the traced metric body (the counterpart of
    a callback): would sync the host every round."""
    return torch.as_tensor(state["hists"].cpu().numpy().sum())


def _j_traced_bool_metric(state):
    if state["hists"].sum() > 0:
        return state["hists"].sum()
    return jnp.float32(0.0)


def _t_traced_bool_metric(state):
    """Data-dependent control flow on a traced truth value."""
    if state["hists"].sum() > 0:
        return state["hists"].sum()
    return torch.tensor(0.0)


def _j_oversized_metric(state):
    del state
    return jnp.zeros((128, 64), jnp.float32)


def _t_oversized_metric(state):
    """Output far beyond the per-round size budget."""
    del state
    return torch.zeros((128, 64))


def _missing_hists(get):
    cnn = get("cnn")
    orig = cnn.materialize

    def materialize(ds, plan_t, key):
        out = dict(orig(ds, plan_t, key))
        out.pop("hists")          # schema violation: engines key on it
        return out

    return dataclasses.replace(cnn, materialize=materialize)


# ---------------------------------------------------------------------------
# Layer 1: contract passes
# ---------------------------------------------------------------------------

class TestSeededViolationsAtDeepValidate:
    """Each seeded violation surfaces as the reference's structured
    diagnostic, raised by validate(deep=True) before any run."""

    def test_bad_selection_result_dtype_is_A003(self):
        with _temp_strategy("_an_bad_dtype", _t_bad_dtype_strategy):
            codes, err = _deep_codes(_spec(strategies=("_an_bad_dtype",)))
        assert codes == _jstrategy_codes(_j_bad_dtype_strategy) == ["A003"]
        d = next(d for d in err.diagnostics if d.code == "A003")
        assert d.kind == "strategy" and d.name == "_an_bad_dtype"

    def test_traced_bool_concretization_is_A001(self):
        with _temp_strategy("_an_traced_bool", _t_traced_bool_strategy):
            codes, err = _deep_codes(_spec(strategies=("_an_traced_bool",)))
        assert codes == _jstrategy_codes(_j_traced_bool_strategy) == ["A001"]
        errs = err.findings.errors()
        assert [d.code for d in errs] == ["A001"]
        assert "concretizes" in errs[0].message
        assert errs[0].detail["error"] == "GuardOnDataDependentSymNode"

    def test_missing_hists_key_is_A101(self):
        with _temp_workload("_an_no_hists", _missing_hists(get_workload)):
            codes, err = _deep_codes(_spec(workload="_an_no_hists"))
        want = _errors(jan.check_workload("_an_no_hists",
                                          _missing_hists(jget_workload)))
        assert codes == want == ["A101"]
        assert any(d.code == "A101" and d.kind == "workload"
                   and d.name == "_an_no_hists"
                   for d in err.findings.errors())

    def test_traced_budget_is_A004(self):
        with _temp_strategy("_an_traced_budget", _t_traced_budget_strategy):
            codes, _ = _deep_codes(_spec(strategies=("_an_traced_budget",)))
        assert codes == _jstrategy_codes(_j_traced_budget_strategy) == [
            "A004"]

    def test_const_seeded_prng_is_A006(self):
        with _temp_strategy("_an_const_seed", _t_const_seeded_strategy):
            codes, err = _deep_codes(_spec(strategies=("_an_const_seed",)))
        assert codes == _jstrategy_codes(_j_const_seeded_strategy) == ["A006"]
        d = err.findings.by_code("A006")[0]
        assert d.detail["primitive"] == "repro_torch.random_seed.default"
        # ``random`` folds the engine's key and hashes it with tensor
        # constants: no seeded key.
        from repro_torch.analysis import check_strategy
        assert not check_strategy("random", STRATEGIES["random"],
                                  separability=False, device="cpu")

    def test_clean_spec_passes_deep(self):
        _spec(strategies=("labelwise", "kl", "entropy")).validate(
            deep=True, device="cpu")

    def test_contract_error_renders_codes(self):
        with _temp_strategy("_an_bad_dtype", _t_bad_dtype_strategy):
            with pytest.raises(ContractError, match="A003"):
                _spec(strategies=("_an_bad_dtype",)).validate(
                    deep=True, device="cpu")


class TestMetricContract:
    """The A3xx pass over the repro_torch.obs metric registry."""

    def test_callback_metric_is_A005_at_deep_validate(self):
        with _temp_metric("_an_cb_metric", _t_callback_metric,
                          _j_callback_metric, requires=("hists",)):
            codes, err = _deep_codes(_spec(telemetry=("_an_cb_metric",)))
            want = _errors(jan.check_metric("_an_cb_metric",
                                            num_classes=10))
        assert codes == want == ["A005"]
        assert any(d.code == "A005" and d.kind == "metric"
                   and d.name == "_an_cb_metric"
                   for d in err.findings.errors())

    def test_untraceable_metric_is_A301(self):
        with _temp_metric("_an_bool_metric", _t_traced_bool_metric,
                          _j_traced_bool_metric, requires=("hists",)):
            codes, err = _deep_codes(_spec(telemetry=("_an_bool_metric",)))
            want = _errors(jan.check_metric("_an_bool_metric"))
        assert codes == want == ["A301"]
        errs = err.findings.errors()
        assert [d.code for d in errs] == ["A301"]
        assert "concretizes" in errs[0].message

    def test_oversized_metric_is_A302(self):
        with _temp_metric("_an_big_metric", _t_oversized_metric,
                          _j_oversized_metric, axes=("a", "b")):
            findings = check_metric("_an_big_metric", device="cpu")
            want = jan.check_metric("_an_big_metric")
        assert _errors(findings) == _errors(want) == ["A302"]
        assert findings.errors()[0].detail["size"] == 128 * 64

    def test_axes_rank_mismatch_is_A302(self):
        with _temp_metric("_an_rank_metric", lambda s: s["mask"],
                          lambda s: s["mask"], requires=("mask",)):
            findings = check_metric("_an_rank_metric", device="cpu")
            want = jan.check_metric("_an_rank_metric")
        assert _errors(findings) == _errors(want) == ["A302"]
        assert any("rank" in d.message for d in findings.errors())

    def test_check_true_blocks_broken_metric(self):
        with pytest.raises(ContractError):
            register_metric("_an_reject_metric", _t_callback_metric,
                            requires=("hists",), check=True, device="cpu")
        assert "_an_reject_metric" not in registered_metrics()

    def test_builtin_metrics_pass_check(self):
        from repro_torch.obs import get_metric
        for name in registered_metrics():
            if name.startswith("_"):
                continue
            findings = check_metric(name, get_metric(name), device="cpu")
            assert not findings.errors(), (name, findings.render())


class TestRegistrationTimeCheck:
    def test_check_true_blocks_broken_registration(self):
        with pytest.raises(ContractError):
            register_strategy("_an_reject_me", _t_bad_dtype_strategy,
                              check=True, device="cpu")
        assert "_an_reject_me" not in STRATEGIES
        assert "_an_reject_me" not in _REGISTRY_ORDER

    def test_check_true_accepts_clean_strategy(self):
        register_strategy("_an_ok2", STRATEGIES["labelwise"], check=True,
                          device="cpu")
        STRATEGIES.pop("_an_ok2", None)
        _REGISTRY_ORDER.remove("_an_ok2")

    def test_check_true_accepts_builtin_workload(self):
        register_workload("_an_cnn3", get_workload("cnn"), check=True,
                          device="cpu")
        _WORKLOADS.pop("_an_cnn3", None)


class TestRegistrySweep:
    def test_builtin_registries_are_clean(self):
        findings = check_registries(device="cpu")
        # Other test files register "_test_*" entries (some deliberately
        # broken, which the sweep rightly flags): the builtin surface itself
        # must be clean.
        errs = [d for d in findings.errors() if not d.name.startswith("_")]
        assert errs == []
        assert {d.name for d in findings.by_code("A007")} >= {
            "random", "labelwise", "labelwise_priority"}

    def test_kernel_ops_are_one_node_each(self):
        """Each kernel's launch is one ``repro_torch`` op in a traced graph
        (its fake form answering), on the CPU as on the card: the
        counterpart of ``pallas_call`` in a jaxpr.  The attention and SSD
        Functions' ``vmap`` rules keep them out of a functionalised trace,
        so their graphs are ``make_fx``'s own."""
        from torch.fx.experimental.proxy_tensor import make_fx

        from repro_torch.kernels.dispatch import masked_weighted_mean
        from repro_torch.kernels.flash_attention import gqa_flash_attention
        from repro_torch.kernels.ssd_scan import ssd_apply

        def ops_of(fn, *args):
            return graph_ops(make_fx(fn, tracing_mode="fake",
                                     _allow_non_fake_inputs=True)(*args))

        cnn, lm = get_workload("cnn"), get_workload("lm")
        ds = cnn.make_dataset("cpu")
        plan = torch.zeros((4, 6), dtype=torch.int32)
        key = torch.zeros(2, dtype=torch.int64)
        gm, _ = trace_graph(lambda p, k: cnn.materialize(ds, p, k), plan,
                            key)
        assert graph_ops(gm)["repro_torch.label_hist.default"] == 1
        tree = {"w": torch.zeros(5, 3, 2), "b": torch.zeros(5, 2)}
        gm, _ = trace_graph(masked_weighted_mean, tree, torch.ones(5))
        assert graph_ops(gm)["repro_torch.weighted_agg.default"] == 1
        lds = lm.make_dataset("cpu")
        params = lm.init(rng.PRNGKey(0), lds)
        batch = {"tokens": torch.zeros((6, 16), dtype=torch.int64),
                 "labels": torch.zeros(6, dtype=torch.int32),
                 "valid": torch.ones(6, dtype=torch.bool)}
        ops = ops_of(lm.make_loss(lds), params, batch)
        assert ops["repro_torch.flash_attention.default"] == 2

        def attn_grad(q, k, v):
            q.requires_grad_(True)
            o = gqa_flash_attention(q, k, v)
            return torch.autograd.grad(o.sum(), q)[0]

        ops = ops_of(attn_grad, *[torch.zeros(1, 8, 2, 16) for _ in range(3)])
        assert ops["repro_torch.flash_attention_bwd.default"] == 1
        ops = ops_of(lambda x, dt, a, b, c: ssd_apply(x, dt, a, b, c,
                                                      chunk=16),
                     torch.zeros(1, 32, 2, 4), torch.zeros(1, 32, 2),
                     torch.zeros(2), torch.zeros(1, 32, 1, 8),
                     torch.zeros(1, 32, 1, 8))
        assert ops["repro_torch.ssd_scan.default"] == 1


# ---------------------------------------------------------------------------
# Layer 1b: block-separability classification
# ---------------------------------------------------------------------------

FIXTURES = {
    "_bad_dtype": (_j_bad_dtype_strategy, _t_bad_dtype_strategy),
    "_traced_bool": (_j_traced_bool_strategy, _t_traced_bool_strategy),
    "_traced_budget": (_j_traced_budget_strategy, _t_traced_budget_strategy),
    "_const_seeded": (_j_const_seeded_strategy, _t_const_seeded_strategy),
    "_nonsep": (_j_nonsep_strategy, _t_nonsep_strategy),
}


def _verdict(v):
    return v.separable, v.scores_dep, v.mask_consistent


class TestSeparabilityMatrix:
    ROW_WISE = ("labelwise", "labelwise_unnorm", "coverage", "kl",
                "entropy", "full", "dirichlet_uniformity")
    BUILTINS = ROW_WISE + ("random", "labelwise_priority")

    @pytest.mark.parametrize("name", BUILTINS)
    def test_builtin_matrix(self, name):
        """The port's classifier on the port's callable gives the
        reference's verdict on the reference's: row-wise scores for the
        seven, const for ``random``, global for ``labelwise_priority``."""
        got = classify_strategy(STRATEGIES[name], name=name, device="cpu")
        want = jclassify(JSTRATEGIES[name], name=name)
        assert _verdict(got) == _verdict(want), (name, got.reasons)
        assert got.scores_dep == {"random": "const",
                                  "labelwise_priority": "global"}.get(
                                      name, "row")

    @pytest.mark.parametrize("name", sorted(FIXTURES))
    def test_fixture_matrix(self, name):
        jfn, tfn = FIXTURES[name]
        got = classify_strategy(tfn, name=name, device="cpu")
        assert _verdict(got) == _verdict(jclassify(jfn, name=name)), (
            name, got.reasons)

    def test_labelwise_priority_is_global(self):
        v = classify_strategy(STRATEGIES["labelwise_priority"],
                              name="labelwise_priority", device="cpu")
        assert not v.separable
        assert v.scores_dep == "global"
        assert any("client axis" in r for r in v.reasons)

    def test_custom_global_denominator_caught_statically(self):
        v = classify_strategy(_t_nonsep_strategy, name="_nonsep",
                              probe=False, device="cpu")
        assert not v.separable and v.scores_dep == "global"
        assert v.mask_consistent is None

    def test_hier_engine_rejects_custom_non_separable(self):
        """A non-separable EXTENSION strategy (not in the denylist) is
        refused by engine='hier' before the run, by the classifier."""
        from repro_torch.fl.population import NON_BLOCK_SEPARABLE
        assert "_an_nonsep" not in NON_BLOCK_SEPARABLE
        with _temp_strategy("_an_nonsep", _t_nonsep_strategy):
            spec = _spec(strategies=("_an_nonsep",), engine="hier",
                         scenarios=(ScenarioSpec.from_case(
                             "case1b", samples_per_client=8),),
                         eval_n_per_class=2)
            with pytest.raises(ValueError, match="not block-separable"):
                run(spec, device="cpu")

    def test_allowlist_vouches_past_classifier(self):
        from repro_torch.fl.population import (ASSUME_BLOCK_SEPARABLE,
                                               _check_block_separable)
        with _temp_strategy("_an_vouched", _t_nonsep_strategy):
            with pytest.raises(ValueError):
                _check_block_separable("_an_vouched", "hier", 10, "cpu")
            ASSUME_BLOCK_SEPARABLE.add("_an_vouched")
            try:
                _check_block_separable("_an_vouched", "hier", 10, "cpu")
            finally:
                ASSUME_BLOCK_SEPARABLE.discard("_an_vouched")


# ---------------------------------------------------------------------------
# Layer 2: repo AST lint + CLI
# ---------------------------------------------------------------------------

class TestRepoLint:
    def test_repo_is_lint_clean(self):
        findings = run_repo_checks()
        assert findings.errors() == []

    @pytest.mark.parametrize("line", [
        "from repro_torch.models import cnn_init\n",
        "from ..models import cnn_init\n",
        "from ..data import ImageDataset\n"])
    def test_engine_import_rule_fires(self, tmp_path, line):
        from repro_torch.analysis.ast_checks import _check_engine_imports
        bad = tmp_path / "src" / "repro_torch" / "fl" / "sim.py"
        bad.parent.mkdir(parents=True)
        bad.write_text(line)
        f = Findings()
        _check_engine_imports(tmp_path, f)
        assert [d.code for d in f.errors()] == ["L001"]

    def test_numpy_in_traced_body_rule_fires(self, tmp_path):
        """L004's traced bodies: an ``autograd.Function``'s forward and a
        function that calls a ``torch.func`` transform; a plain function
        may call numpy."""
        from repro_torch.analysis.ast_checks import _check_numpy_in_traced
        src = tmp_path / "src" / "repro_torch" / "m.py"
        src.parent.mkdir(parents=True)
        src.write_text(
            "import numpy as np\nimport torch\n"
            "class F(torch.autograd.Function):\n"
            "    @staticmethod\n"
            "    def forward(x):\n"
            "        return x + np.sum(1)\n"
            "def step(f, x):\n"
            "    np.asarray(x)\n"
            "    return torch.func.vmap(f)(x)\n"
            "def plain(x):\n"
            "    return np.asarray(x)\n")
        f = Findings()
        _check_numpy_in_traced(tmp_path, f)
        assert sorted((d.code, d.detail["function"]) for d in f.errors()) \
            == [("L004", "forward"), ("L004", "step")]


class TestCLI:
    def test_module_exits_zero_on_clean_repo(self, _cli):
        """Exit 0 on the repo as it stands, and each finding has the keys of
        the reference's ``Diagnostic.to_dict``."""
        stdout, stderr = _cli.communicate(timeout=600)
        assert _cli.returncode == 0, stdout + stderr
        out = json.loads(stdout)
        assert out["errors"] == 0
        want = set(jan.Diagnostic("A007", "info", "strategy", "x",
                                  "m").to_dict())
        assert out["findings"] and all(set(rec) == want
                                       for rec in out["findings"])
        assert {rec["name"] for rec in out["findings"]
                if rec["code"] == "A007"} >= set(
                    TestSeparabilityMatrix.BUILTINS)
