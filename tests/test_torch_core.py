"""Parity of the PyTorch port's core layer with the JAX reference on the CPU:
label plans, image templates, label statistics and the selection registry.

Inputs are made with NumPy and fed to both stacks.  Plans, templates,
histograms, masks and orders must be bit-equal; float scores agree to
rtol 1e-6 (they are in fact bit-equal: the port sums the class axis in the
reference's CPU order, see ``repro_torch.core.label_stats.class_sum``).
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import clustering as jclust  # noqa: E402
from repro.core import kl as jkl  # noqa: E402
from repro.core import label_stats as jls  # noqa: E402
from repro.core import noniid as jnoniid  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.data.synthetic import ImageDataset as JImageDataset  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import clustering as tclust  # noqa: E402
from repro_torch.core import kl as tkl  # noqa: E402
from repro_torch.core import label_stats as tls  # noqa: E402
from repro_torch.core import noniid as tnoniid  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.data import ImageDataset as TImageDataset  # noqa: E402

C = 10
ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _hist_matrix() -> np.ndarray:
    """(N, C) histograms covering every selection regime: empty clients,
    single-label clients (σ² = 0), permuted copies (exact score ties), ragged
    sizes, two-label and near-uniform clients."""
    rng = np.random.default_rng(7)
    rows = [np.zeros(C), np.zeros(C)]
    for k in range(4):
        h = np.zeros(C)
        h[k] = 50 + 10 * k
        rows.append(h)
    for k in range(4):
        h = np.zeros(C)
        h[k], h[k + 5] = 60, 40
        rows.append(h)
    base = rng.integers(0, 30, C).astype(np.float64)
    rows += [base, base[::-1].copy(), np.roll(base, 3)]
    for _ in range(20):
        h = rng.integers(0, 40, C).astype(np.float64)
        h[rng.random(C) < 0.3] = 0
        rows.append(h)
    for p in (np.full(C, 0.1), np.r_[np.full(5, 0.19), np.full(5, 0.01)]):
        rows.append(rng.multinomial(290, p).astype(np.float64))
    return np.stack(rows).astype(np.float32)


HISTS = _hist_matrix()


# ---------------------------------------------------------------------------
# Plans and templates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", jnoniid.CASES)
def test_case_plans_bit_equal(case):
    args = (case, 3, 4, 12)
    kw = dict(num_classes=C, samples_per_client=29, majority=20)
    np.testing.assert_array_equal(tnoniid.case_label_plan(*args, **kw),
                                  jnoniid.case_label_plan(*args, **kw))


def test_partitioner_plans_bit_equal():
    np.testing.assert_array_equal(
        tnoniid.bias_mix_plan(5, 16, 0.4, num_rounds=2),
        jnoniid.bias_mix_plan(5, 16, 0.4, num_rounds=2))
    np.testing.assert_array_equal(tnoniid.dirichlet_plan(5, 16, 0.3),
                                  jnoniid.dirichlet_plan(5, 16, 0.3))
    plan = jnoniid.case_label_plan("case2b", 1, 3, 5)
    for t in range(5):
        np.testing.assert_array_equal(tnoniid.plan_round(plan, t),
                                      jnoniid.plan_round(plan, t))
    assert tnoniid.CASES == jnoniid.CASES
    assert (tnoniid.SAMPLES_PER_CLIENT, tnoniid.MAJORITY_PER_CLIENT,
            tnoniid.MINORITY_PER_CLIENT) == (jnoniid.SAMPLES_PER_CLIENT,
                                             jnoniid.MAJORITY_PER_CLIENT,
                                             jnoniid.MINORITY_PER_CLIENT)


def test_image_templates_bit_equal_and_sampler_shapes():
    ref = JImageDataset()
    port = TImageDataset(device="cpu")
    np.testing.assert_array_equal(port.templates.numpy(), _np(ref.templates))
    labels = torch.tensor([[0, 3, -1], [9, -1, -1]], dtype=torch.int32)
    imgs = port.sample(rng.PRNGKey(0), labels)
    assert imgs.shape == (2, 3, 28, 28, 1) and imgs.dtype == torch.float32
    assert torch.all(imgs[labels < 0] == 0)
    x, y = port.test_set(3)
    x2, _ = port.test_set(3)
    np.testing.assert_array_equal(y.numpy(), _np(ref.test_set(3)[1]))
    assert torch.equal(x, x2)  # the eval set has its own fixed key


# ---------------------------------------------------------------------------
# Label statistics, KL, area index
# ---------------------------------------------------------------------------

def test_histogram_plain_version_bit_equal():
    rng = np.random.default_rng(3)
    labels = rng.integers(-1, C + 2, (6, 37)).astype(np.int32)
    valid = rng.random((6, 37)) > 0.25
    for v in (None, valid):
        ref = jls.histogram(jnp.asarray(labels), C,
                            None if v is None else jnp.asarray(v))
        port = tls.histogram(_t(labels), C, None if v is None else _t(v))
        np.testing.assert_array_equal(port.numpy(), _np(ref))


STATS = [
    ("rank_remap_values", jls.rank_remap_values, tls.rank_remap_values),
    ("label_variance", jls.label_variance, tls.label_variance),
    ("label_variance_normed", jls.label_variance_normed,
     tls.label_variance_normed),
    ("coverage", jls.coverage, tls.coverage),
    ("empirical_pdf", jls.empirical_pdf, tls.empirical_pdf),
    ("kl_forward", lambda h: jkl.kl_to_uniform(h, "forward"),
     lambda h: tkl.kl_to_uniform(h, "forward")),
    ("kl_reverse", lambda h: jkl.kl_to_uniform(h, "reverse"),
     lambda h: tkl.kl_to_uniform(h, "reverse")),
    ("uniformity_score", jkl.uniformity_score, tkl.uniformity_score),
    ("area_index", lambda h: jclust.area_index(h),
     lambda h: tclust.area_index(h)),
    ("selection_priority", jclust.selection_priority,
     tclust.selection_priority),
]


@pytest.mark.parametrize("name,ref_fn,port_fn", STATS,
                         ids=[s[0] for s in STATS])
def test_label_statistics_match(name, ref_fn, port_fn):
    ref = _np(jax.jit(ref_fn)(jnp.asarray(HISTS)))
    port = port_fn(_t(HISTS)).numpy()
    assert port.dtype == ref.dtype
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)


def test_kl_divergence_matches():
    rng = np.random.default_rng(4)
    p = rng.dirichlet(np.ones(C), 5).astype(np.float32)
    p[0, :3] = 0
    q = rng.dirichlet(np.ones(C), 5).astype(np.float32)
    np.testing.assert_allclose(tkl.kl_divergence(_t(p), _t(q)).numpy(),
                               _np(jkl.kl_divergence(p, q)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Selection registry
# ---------------------------------------------------------------------------

def test_strategy_registry_ids_match_reference_prefix():
    # Both packages register id 8 from their fl.experiment module.
    import repro.fl.experiment  # noqa: F401
    import repro_torch.fl.experiment  # noqa: F401
    port = tsel.registered_strategies()
    assert port == ("random", "labelwise", "labelwise_unnorm", "coverage",
                    "kl", "entropy", "full", "labelwise_priority",
                    "dirichlet_uniformity")
    assert jsel.registered_strategies()[:len(port)] == port
    for i, name in enumerate(port):
        assert tsel.strategy_id(name) == i
    with pytest.raises(KeyError):
        tsel.get_strategy("no-such-strategy")
    with pytest.raises(ValueError):
        tsel.register_strategy("labelwise", tsel.select_labelwise)


DETERMINISTIC = [s for s in tsel.registered_strategies() if s != "random"]


@pytest.mark.parametrize("n_select", [3, 9, 40])
@pytest.mark.parametrize("name", DETERMINISTIC)
def test_strategies_bit_equal(name, n_select):
    def ref_fn(h):
        r = jsel.get_strategy(name)(jax.random.PRNGKey(0), h, n_select)
        return r.mask, r.scores, r.order

    mask, scores, order = jax.jit(ref_fn)(jnp.asarray(HISTS))
    port = tsel.get_strategy(name)(None, _t(HISTS), n_select)
    np.testing.assert_array_equal(port.mask.numpy(), _np(mask))
    np.testing.assert_array_equal(port.order.numpy(), _np(order))
    np.testing.assert_allclose(port.scores.numpy(), _np(scores),
                               rtol=1e-6, atol=0)
    assert port.order.dtype == torch.int32 and port.mask.dtype == torch.float32
    assert port.budget == jsel.get_strategy(name)(
        jax.random.PRNGKey(0), jnp.asarray(HISTS), n_select).budget


@pytest.mark.parametrize("n_select", [3, 40])
def test_random_strategy_structure(n_select):
    """``random``'s budget, validity gate and determinism under a key (its
    draw against the reference's: tests/test_torch_experiment.py)."""
    res = tsel.get_strategy("random")(rng.PRNGKey(11), _t(HISTS), n_select)
    valid = HISTS.sum(-1) > 0
    mask = res.mask.numpy()
    assert res.budget == min(n_select, HISTS.shape[0])
    assert mask[~valid].sum() == 0
    assert mask.sum() == min(n_select, valid.sum())
    order = res.order.numpy()
    assert sorted(order.tolist()) == list(range(HISTS.shape[0]))
    assert mask[order[res.budget:]].sum() == 0
    again = tsel.get_strategy("random")(rng.PRNGKey(11), _t(HISTS), n_select)
    assert torch.equal(res.order, again.order)


def test_topn_mask_and_budget_match():
    rng = np.random.default_rng(5)
    scores = rng.integers(0, 4, 17).astype(np.float32)  # many exact ties
    valid = rng.random(17) > 0.3
    for n in (0, 4, 17):
        jm, jo = jsel.topn_mask(jnp.asarray(scores), jnp.asarray(valid), n)
        tm, to = tsel.topn_mask(_t(scores), _t(valid), n)
        np.testing.assert_array_equal(tm.numpy(), _np(jm))
        np.testing.assert_array_equal(to.numpy(), _np(jo))
    res = tsel.SelectionResult(torch.zeros(5), torch.zeros(5),
                               torch.arange(5, dtype=torch.int32), budget=9)
    assert tsel.selection_budget(res, 3, 5) == 5
    res.budget = None
    assert tsel.selection_budget(res, 3, 5) == 3


def test_aggregator_registry_ids():
    from repro.core import aggregation as jagg
    port = tagg.registered_aggregators()
    assert port == ("fedavg", "fedsgd", "clustered_fedavg", "clustered_fedsgd",
                    "clustered_fedavg4", "clustered_fedavg8", "median",
                    "trimmed_mean", "krum")
    assert jagg.registered_aggregators()[:9] == port
    assert tagg.aggregator_id("fedsgd") == 1
    assert tagg.aggregator_id("krum") == 8
    for name in port:
        ja, ta = jagg.get_aggregator(name), tagg.get_aggregator(name)
        assert (ta.base, ta.n_clusters, ta.kmeans_iters) == (
            ja.base, ja.n_clusters, ja.kmeans_iters)
        assert (ta.reduce is None) == (ja.reduce is None)
    with pytest.raises(KeyError):
        tagg.get_aggregator("fedprox")
    with pytest.raises(ValueError):
        tagg.Aggregator("fedprox")


def test_masked_mean_and_interpolate_match():
    from repro.core import aggregation as jagg
    rng = np.random.default_rng(6)
    stacked = {"a": rng.standard_normal((4, 3, 5)).astype(np.float32),
               "b": rng.standard_normal((4, 7)).astype(np.float32)}
    mask = np.array([1, 0, 1, 1], np.float32)
    sizes = np.array([3, 5, 8, 1], np.float32)
    ref = jagg.masked_mean({k: jnp.asarray(v) for k, v in stacked.items()},
                           jnp.asarray(mask), jnp.asarray(sizes))
    port = tagg.masked_mean({k: _t(v) for k, v in stacked.items()},
                            _t(mask), _t(sizes))
    g = {k: v[0] for k, v in stacked.items()}
    ref_i = jagg.interpolate(g, ref, 0.5)
    port_i = tagg.interpolate({k: _t(v) for k, v in g.items()}, port, 0.5)
    for k in stacked:
        np.testing.assert_allclose(port[k].numpy(), _np(ref[k]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(port_i[k].numpy(), _np(ref_i[k]),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Package boundary and device policy
# ---------------------------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path.name}:{node.lineno} imports {name}")


def test_entry_points_without_device_raise_on_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from repro_torch import resolve_device
    from repro_torch.configs import FLConfig
    from repro_torch.fl import run_fl_host
    from repro_torch.models import cnn_init
    plan = tnoniid.case_label_plan("iid", 0, 1, 4, samples_per_client=8)
    cfg = FLConfig(num_clients=4, clients_per_round=2, global_epochs=1,
                   local_epochs=1, batch_size=4)
    for call in (lambda: run_fl_host(plan, cfg),
                 lambda: TImageDataset(),
                 lambda: cnn_init(),
                 lambda: resolve_device(),
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_register_strategy_takes_the_check_keyword():
    """As the reference's: ``check=False`` registers (here a builtin
    re-registered with its own callable, which keeps its id);
    ``check=True`` runs the contract pass first, so a broken strategy (int
    mask, float order) raises ``ContractError`` with the reference's code,
    A003, and registers nothing, and a clean one registers."""
    from repro_torch.analysis import ContractError
    before = tsel.registered_strategies()
    fn = tsel.get_strategy("random")
    assert tsel.register_strategy("random", fn, overwrite=True,
                                  check=False) is fn
    assert tsel.registered_strategies() == before

    def bad(key, hists, n_select):
        r = fn(key, hists, n_select)
        return tsel.SelectionResult(r.mask.to(torch.int32), r.scores,
                                    r.order.to(torch.float32), r.budget)

    with pytest.raises(ContractError) as ei:
        tsel.register_strategy("_checked_strategy", bad, check=True,
                               device="cpu")
    assert {d.code for d in ei.value.findings.errors()} == {"A003"}
    assert tsel.registered_strategies() == before
    try:
        assert tsel.register_strategy("_checked_strategy", fn, check=True,
                                      device="cpu") is fn
        assert tsel.registered_strategies() == before + ("_checked_strategy",)
    finally:
        tsel.STRATEGIES.pop("_checked_strategy", None)
        if "_checked_strategy" in tsel._REGISTRY_ORDER:
            tsel._REGISTRY_ORDER.remove("_checked_strategy")
