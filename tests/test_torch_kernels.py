"""Parity of the port's kernel modules with the JAX reference on the CPU.

On the CPU the port's kernel wrappers take their plain PyTorch versions (the
CUDA kernels themselves are held against those on the card by
``chip_smoke.py``).  The JAX side runs its Pallas kernels as its own tests
do on the CPU: in interpret mode, and through the dispatch layer with
``backend="pallas_interpret"`` and ``"reference"``.

Tolerances: histograms are bit-equal (sums of 0/1 weights, exact in
float32); the weighted sums agree to rtol 1e-6 / atol 1e-6 in float32 (one
float32 rounding per term, summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels.label_hist.label_hist import label_hist_kernel as jhist  # noqa: E402
from repro.kernels.weighted_agg.weighted_agg import weighted_agg_kernel as jagg  # noqa: E402

from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.kernels import dispatch as tdispatch  # noqa: E402
from repro_torch.kernels.label_hist import label_hist_kernel, label_hist_ref  # noqa: E402
from repro_torch.kernels.weighted_agg import (weighted_agg_kernel,  # noqa: E402
                                              weighted_agg_ref)

JAX_BACKENDS = ("pallas_interpret", "reference")


def _labels(b, n, c, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(-2, c + 2, (b, n)).astype(np.int32)  # out of range too
    valid = rng.random((b, n)) > 0.2
    return labels, valid


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _leaves(k, seed):
    """A stacked client tree at micro CNN widths, every leaf (K, ...)."""
    rng = np.random.default_rng(seed)
    shapes = {"conv1.w": (4, 1, 3, 3), "conv1.b": (4,), "fc1.w": (49, 6),
              "fc2.b": (10,)}
    return {n: rng.standard_normal((k,) + s).astype(np.float32)
            for n, s in shapes.items()}


# ---------------------------------------------------------------------------
# label_hist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,c", [(6, 29, 10), (7, 33, 5), (9, 600, 13)])
def test_label_hist_plain_version_equals_pallas_kernel(b, n, c):
    labels, valid = _labels(b, n, c, seed=b * n)
    ref = np.asarray(jhist(jnp.asarray(labels), jnp.asarray(valid), c,
                           interpret=True))
    port = label_hist_kernel(_t(labels), _t(valid), c)
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(label_hist_ref(_t(labels), _t(valid), c)
                                  .numpy(), ref)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("with_valid", [False, True])
def test_client_histograms_and_statistics_match(backend, with_valid):
    labels, valid = _labels(12, 45, 10, seed=3)
    labels = labels.reshape(3, 4, 45)          # leading axes are flattened
    valid = valid.reshape(3, 4, 45) if with_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else _t(valid)
    # Jitted, as the reference's engines run it.
    jh, js = jax.jit(lambda lab, v: jdispatch.client_statistics(
        lab, 10, v, backend=backend))(jnp.asarray(labels), jv)
    for tb in ("auto", "reference"):
        th, ts = tdispatch.client_statistics(_t(labels), 10, tv, backend=tb)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=0)


def test_label_hist_wrapper_checks_its_inputs():
    labels, valid = _labels(3, 8, 4, seed=0)
    with pytest.raises(TypeError):
        label_hist_kernel(_t(labels).long(), _t(valid), 4)
    with pytest.raises(ValueError):
        label_hist_kernel(_t(labels), _t(valid)[:, :4], 4)


# ---------------------------------------------------------------------------
# weighted_agg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(3, 10), (5, 2048), (30, 4100)])
def test_weighted_agg_plain_version_matches_pallas_kernel(k, n):
    rng = np.random.default_rng(k + n)
    stacked = rng.standard_normal((k, n)).astype(np.float32)
    scales = rng.random(k).astype(np.float32)
    ref = np.asarray(jagg(jnp.asarray(stacked), jnp.asarray(scales),
                          interpret=True))
    port = weighted_agg_kernel(_t(stacked), _t(scales))
    assert port.dtype == torch.float32 and port.shape == (n,)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(weighted_agg_ref(_t(stacked), _t(scales))
                               .numpy(), ref, rtol=1e-6, atol=1e-6)


def test_weighted_agg_keeps_bf16():
    rng = np.random.default_rng(1)
    stacked = _t(rng.standard_normal((4, 33)).astype(np.float32))
    scales = _t(rng.random(4).astype(np.float32))
    out = weighted_agg_kernel(stacked.to(torch.bfloat16), scales)
    assert out.dtype == torch.bfloat16
    want = (scales[:, None] * stacked.to(torch.bfloat16).float()).sum(0)
    torch.testing.assert_close(out, want.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_masked_weighted_mean_matches(backend, weighted):
    k = 5
    leaves = _leaves(k, seed=4)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    sizes = np.array([29, 3, 17, 1, 8], np.float32) if weighted else None
    ref = jdispatch.masked_weighted_mean(
        {n: jnp.asarray(v) for n, v in leaves.items()}, jnp.asarray(mask),
        None if sizes is None else jnp.asarray(sizes), backend=backend)
    for tb in ("auto", "reference"):
        port = tdispatch.masked_weighted_mean(
            {n: _t(v) for n, v in leaves.items()}, _t(mask),
            None if sizes is None else _t(sizes), backend=tb)
        for name in leaves:
            assert port[name].shape == leaves[name].shape[1:]
            np.testing.assert_allclose(port[name].numpy(),
                                       np.asarray(ref[name]),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_weighted_sum_tree_matches_and_keeps_leaf_dtype(backend):
    leaves = _leaves(4, seed=5)
    w = np.array([0.5, -1.0, 2.0, 0.25], np.float32)
    ref = jdispatch.weighted_sum_tree(
        {n: jnp.asarray(v) for n, v in leaves.items()}, jnp.asarray(w),
        backend=backend)
    for tb in ("auto", "reference"):
        port = tdispatch.weighted_sum_tree(
            {n: _t(v) for n, v in leaves.items()}, _t(w), backend=tb)
        for name in leaves:
            np.testing.assert_allclose(port[name].numpy(),
                                       np.asarray(ref[name]),
                                       rtol=1e-6, atol=1e-6)
        bf = tdispatch.weighted_sum_tree(
            {n: _t(v).to(torch.bfloat16) for n, v in leaves.items()}, _t(w),
            backend=tb)
        assert all(v.dtype == torch.bfloat16 for v in bf.values())
    jbf = jdispatch.weighted_sum_tree(
        {n: jnp.asarray(v, jnp.bfloat16) for n, v in leaves.items()},
        jnp.asarray(w), backend=backend)
    assert all(v.dtype == jnp.bfloat16 for v in jbf.values())


@pytest.mark.parametrize("backend", ("auto", "reference"))
def test_empty_selection_gives_zeros(backend):
    leaves = {n: _t(v) for n, v in _leaves(3, seed=6).items()}
    out = tdispatch.masked_weighted_mean(leaves, torch.zeros(3),
                                         torch.ones(3), backend=backend)
    ref = jdispatch.masked_weighted_mean(
        {n: jnp.asarray(v.numpy()) for n, v in leaves.items()},
        jnp.zeros(3), jnp.ones(3), backend="pallas_interpret")
    for name, v in out.items():
        assert torch.count_nonzero(v) == 0
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[name]))


def test_cpu_tensors_launch_no_kernel():
    tkernels.reset_launch_counts()
    labels, valid = _labels(4, 9, 3, seed=2)
    tdispatch.client_histograms(_t(labels), 3, _t(valid))
    tdispatch.masked_weighted_mean({"a": torch.ones(2, 5)}, torch.ones(2))
    assert tkernels.launch_counts() == {"label_hist": 0, "weighted_agg": 0,
                                        "flash_attention": 0, "ssd_scan": 0}
    with pytest.raises(ValueError):
        tdispatch.client_histograms(_t(labels), 3, backend="pallas")
