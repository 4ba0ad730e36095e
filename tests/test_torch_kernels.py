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
from repro.kernels.label_hist import ops as jhist_ops  # noqa: E402
from repro.kernels.weighted_agg.weighted_agg import weighted_agg_kernel as jagg  # noqa: E402

from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.kernels import dispatch as tdispatch  # noqa: E402
from repro_torch.kernels.label_hist import label_hist_kernel, label_hist_ref  # noqa: E402
from repro_torch.kernels.label_hist import label_hist as tlabel_hist  # noqa: E402
from repro_torch.kernels.label_hist import ops as thist_ops  # noqa: E402
from repro_torch.kernels.weighted_agg import (weighted_agg_kernel,  # noqa: E402
                                              weighted_agg_leaves,
                                              weighted_agg_ref)
from repro_torch.kernels.weighted_agg import weighted_agg as tagg  # noqa: E402

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

@pytest.mark.parametrize("b,n,c,invalid_rows", [
    pytest.param(6, 29, 10, False, id="6-29-10"),
    pytest.param(7, 33, 5, False, id="7-33-5"),
    pytest.param(9, 600, 13, False, id="9-600-13"),
    pytest.param(3, 40000, 10, False, id="long-row-3-40000-10"),
    pytest.param(40, 1030, 40, False, id="many-classes-40-1030-40"),
    pytest.param(5, 50, 1, False, id="one-class-5-50-1"),
    pytest.param(6, 1, 10, False, id="one-sample-6-1-10"),
    pytest.param(8, 290, 10, True, id="all-invalid-rows-8-290-10")])
def test_label_hist_plain_version_equals_pallas_kernel(b, n, c, invalid_rows):
    labels, valid = _labels(b, n, c, seed=b * n)
    if invalid_rows:
        valid[::2] = False
    ref = np.asarray(jhist(jnp.asarray(labels), jnp.asarray(valid), c,
                           interpret=True))
    port = label_hist_kernel(_t(labels), _t(valid), c)
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(label_hist_ref(_t(labels), _t(valid), c)
                                  .numpy(), ref)


@pytest.mark.parametrize("b,n,c", [
    pytest.param(6, 29, 10, id="6-29-10"),
    pytest.param(9, 600, 13, id="9-600-13"),
    pytest.param(4, 1, 3, id="one-sample-4-1-3")])
def test_ops_client_statistics_bit_equal(b, n, c):
    """``label_hist.ops.client_statistics`` on (B, n) labels with -1
    padding (whole padded rows too) against the reference's wrapper in
    interpret mode: histograms and scores bit-equal."""
    rng = np.random.default_rng(b * n + c)
    labels = rng.integers(0, c, (b, n)).astype(np.int32)
    labels[rng.random((b, n)) < 0.3] = -1
    labels[1] = -1
    want_h, want_s = jhist_ops.client_statistics(jnp.asarray(labels), c,
                                                 interpret=True)
    got_h, got_s = thist_ops.client_statistics(_t(labels), c)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_h[1].sum() == 0


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


# Shapes across the plan's regimes: one warp a row (the batched grid's 105
# trials x 100 clients, the FL round), warps sharing a row, rows cut into
# chunks (long rows), C on either side of 32, the edges n = 0 and 1, and C so
# large that a block holds only 4 warps' bins.
PLAN_SHAPES = [(100, 290, 10), (10500, 290, 10), (7, 33, 5), (1000, 4096, 62),
               (200, 8192, 10), (8, 1 << 20, 10), (3, 40000, 10),
               (4, 300000, 40), (64, 1000, 33), (2, 5, 12288), (5, 0, 10),
               (9, 1, 10), (2000, 64, 2000)]
# Multiprocessors of an H100 SXM, for the plans of the tests.
H100_SMS = 132


def _plan_segments(plan, rows, n):
    """(row, start, end) of every live team of ``plan``, in flat sample
    indices, as ``HistPlan``'s docstring defines them."""
    for t in range(min(plan.blocks * plan.rows_per_block,
                       rows * plan.chunks_per_row)):
        row, k = divmod(t, plan.chunks_per_row)
        s = row * n + k * plan.chunk
        yield row, s, min(s + plan.chunk, (row + 1) * n)


@pytest.mark.parametrize("b,n,c", PLAN_SHAPES)
def test_label_hist_plan_covers_every_sample_once(b, n, c):
    plan = tlabel_hist.plan_hist(b, n, c, H100_SMS)
    covered = np.zeros(b * n, np.int32)
    chunks = np.zeros(b, np.int32)
    for row, start, end in _plan_segments(plan, b, n):
        assert row * n <= start <= end <= (row + 1) * n
        covered[start:end] += 1
        chunks[row] += 1
    assert (covered == 1).all()
    assert (chunks == plan.chunks_per_row).all()
    # A row cut into chunks is added into the output, which must start at 0.
    assert plan.zero_out == (plan.chunks_per_row > 1)
    if plan.zero_out:
        assert plan.rows_per_block == 1
    assert plan.threads <= 256 and plan.smem_bytes <= 48 * 1024
    assert plan.team_threads in (32, 64, 128, 256)
    tlabel_hist._check_plan(plan, b, n, c)     # the launch's own check


def test_label_hist_plan_of_the_fl_round_is_one_launch_without_split():
    plan = tlabel_hist.plan_hist(100, 290, 10, H100_SMS)
    assert plan.chunks_per_row == 1 and not plan.zero_out
    assert plan.team_threads == 32
    assert 25 <= plan.blocks <= 100
    assert plan.blocks * plan.rows_per_block >= 100
    long_rows = tlabel_hist.plan_hist(8, 1 << 20, 10, H100_SMS)
    assert long_rows.zero_out and long_rows.blocks >= H100_SMS


# Plans the kernel would run wrong: rows or samples left uncovered, an empty
# chunk, too little shared memory, a team that is not whole warps, too many
# threads a block.
_GOOD_PLAN = dict(rows_per_block=4, team_threads=64, chunks_per_row=1,
                  chunk=290, blocks=25, smem_bytes=4 * 64 * 4)


@pytest.mark.parametrize("fault", [
    dict(blocks=24), dict(chunk=289), dict(chunks_per_row=2, chunk=145,
                                           rows_per_block=1, blocks=199),
    dict(chunks_per_row=3, chunk=145, rows_per_block=1, blocks=300),
    dict(smem_bytes=4 * 64 * 4 - 4), dict(team_threads=16, smem_bytes=0),
    dict(team_threads=96, smem_bytes=4 * 96 * 4),
    dict(rows_per_block=8, blocks=13, smem_bytes=8 * 64 * 4),
    dict(smem_bytes=48 * 1024 + 4)])
def test_label_hist_launch_refuses_a_plan_that_misses_the_shape(fault):
    labels = torch.zeros((100, 290), dtype=torch.int32)
    valid = torch.ones((100, 290), dtype=torch.bool)
    tlabel_hist._check_plan(tlabel_hist.HistPlan(**_GOOD_PLAN), 100, 290, 10)
    bad = tlabel_hist.HistPlan(**{**_GOOD_PLAN, **fault})
    with pytest.raises(ValueError, match="for \\(100, 290\\)"):
        tlabel_hist._check_plan(bad, 100, 290, 10)
    # The launch checks the plan first, before it needs the card.
    with pytest.raises(ValueError, match="for \\(100, 290\\)"):
        tlabel_hist._launch_plan(labels, valid, 10, bad)


def test_label_hist_wrapper_raises_from_2_24_samples_a_row():
    for n in (1 << 24, (1 << 24) + 5):
        labels = torch.empty((1, n), dtype=torch.int32)
        valid = torch.empty((1, n), dtype=torch.bool)
        with pytest.raises(ValueError, match="2\\^24"):
            label_hist_kernel(labels, valid, 10)
        with pytest.raises(ValueError, match="2\\^24"):
            tlabel_hist._launch_plan(
                labels, valid, 10, tlabel_hist.plan_hist(1, 290, 10, H100_SMS))


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


# The table of leaves that one weighted_agg launch takes (planned in Python,
# so the CPU can check it; the kernel itself runs on the card).

def test_leaf_table_groups_by_dtype_and_numbers_blocks():
    leaves = [torch.zeros(3, 4100), torch.zeros(3, 64, dtype=torch.bfloat16),
              torch.zeros(3, 10), torch.zeros(3, 0), torch.zeros(3, 1280),
              torch.zeros(3, 8, dtype=torch.bfloat16)]
    outs = [torch.zeros(x.shape[1], dtype=x.dtype) for x in leaves]
    tables = tagg.launch_tables(leaves, outs)
    assert [d for d, _ in tables] == [torch.float32, torch.bfloat16]
    f32, bf16 = tables[0][1], tables[1][1]
    # The empty leaf (index 3) takes no slot; slots keep the leaves' indices.
    assert [s.index for s in f32] == [0, 2, 4]
    assert [s.index for s in bf16] == [1, 5]
    # float32: 4 columns a 16-byte load; 10 columns take scalar loads.
    assert [(s.n, s.vec, s.blocks) for s in f32] == [
        (4100, True, 5), (10, False, 1), (1280, True, 2)]
    assert [s.first_block for s in f32] == [0, 5, 6]
    # bfloat16: 8 columns a load, block starts from 0 again.
    assert [(s.n, s.vec, s.first_block, s.blocks) for s in bf16] == [
        (64, True, 0, 1), (8, True, 1, 1)]


def test_leaf_table_alignment_flags():
    base = torch.zeros(2, 33)
    aligned = base[:, :32].contiguous()
    shifted = torch.zeros(2 * 32 + 1)[1:].view(2, 32)   # 4 bytes off 16
    out = torch.zeros(32)
    assert tagg.vector_width(torch.float32) == 4
    assert tagg.vector_width(torch.bfloat16) == 8
    assert tagg.loads_16_bytes(32, 4, aligned.data_ptr(), out.data_ptr())
    assert not tagg.loads_16_bytes(32, 4, shifted.data_ptr(), out.data_ptr())
    assert not tagg.loads_16_bytes(32, 4, aligned.data_ptr(),
                                   out.data_ptr() + 4)
    assert not tagg.loads_16_bytes(30, 4, aligned.data_ptr(), out.data_ptr())
    (_, table), = tagg.launch_tables([aligned, shifted], [out, out.clone()])
    assert [s.vec for s in table] == [True, False]
    assert [s.blocks for s in table] == [1, 1]


@pytest.mark.parametrize("count", [64, 65, 130, 200])
def test_leaf_table_splits_past_the_cap(count):
    cap = tagg.MAX_LEAVES
    sizes = [(i % 7) * 300 for i in range(count)]     # every 7th leaf empty
    plans = tagg.plan_launches(sizes, [i % 2 == 0 for i in range(count)], 4)
    live = [i for i, n in enumerate(sizes) if n]
    assert [s.index for p in plans for s in p] == live
    assert len(plans) == -(-len(live) // cap)
    assert all(len(p) <= cap for p in plans)
    assert all(len(p) == cap for p in plans[:-1])
    for p in plans:
        starts = [s.first_block for s in p]
        assert starts[0] == 0
        assert starts[1:] == [s.first_block + s.blocks for s in p[:-1]]
        for s in p:
            threads = s.n // 4 if s.vec else s.n
            assert (s.blocks - 1) * tagg.THREADS < threads \
                <= s.blocks * tagg.THREADS


@pytest.mark.parametrize("with_denom", [False, True])
def test_weighted_agg_leaves_equal_per_leaf_plain_and_pallas(with_denom):
    k = 6
    rng = np.random.default_rng(11)
    sizes = [7, 2048, 10, 0, 300]
    stacked = [rng.standard_normal((k, n)).astype(np.float32) for n in sizes]
    scales = rng.random(k).astype(np.float32)
    denom = _t(np.float32(2.5)) if with_denom else None
    leaves = [_t(x) for x in stacked] + [_t(stacked[1]).to(torch.bfloat16)]
    got = weighted_agg_leaves(leaves, _t(scales), denom)
    assert [g.dtype for g in got] == [x.dtype for x in leaves]
    for x, g in zip(leaves, got):
        want = weighted_agg_ref(x, _t(scales))
        if with_denom:
            want = (weighted_agg_ref(x.float(), _t(scales)) / denom).to(x.dtype)
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    for x, g in zip(stacked, got):
        if x.shape[1] == 0:
            assert g.shape == (0,)
            continue
        ref = np.asarray(jagg(jnp.asarray(x), jnp.asarray(scales),
                              interpret=True))
        if with_denom:
            ref = ref / np.float32(2.5)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_weighted_agg_leaves_checks_its_inputs():
    x, w = torch.zeros(3, 5), torch.ones(3)
    with pytest.raises(ValueError):
        weighted_agg_leaves([x, torch.zeros(2, 5)], w)
    with pytest.raises(ValueError):
        weighted_agg_leaves([x], w, torch.ones(2))


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


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_masked_weighted_mean_takes_other_float_dtypes(dtype):
    # The kernel reads float32 and bfloat16; other leaves are summed in
    # float32 and come back in their own dtype, as the reference's mean does.
    k = 5
    leaves = _leaves(k, seed=7)
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    sizes = np.array([3, 8, 2, 5, 1], np.float32)
    tree = {n: _t(v).to(dtype) for n, v in leaves.items()}
    out = tdispatch.masked_weighted_mean(tree, _t(mask), _t(sizes))
    ref = tdispatch.masked_weighted_mean(tree, _t(mask), _t(sizes),
                                         backend="reference")
    jref = jdispatch.masked_weighted_mean(
        {n: jnp.asarray(v.float().numpy()) for n, v in tree.items()},
        jnp.asarray(mask), jnp.asarray(sizes), backend="pallas_interpret")
    tol = 1e-3 if dtype == torch.float16 else 1e-6
    for name in leaves:
        assert out[name].dtype == dtype
        torch.testing.assert_close(out[name], ref[name], rtol=tol, atol=tol)
        np.testing.assert_allclose(out[name].double().numpy(),
                                   np.asarray(jref[name]), rtol=tol, atol=tol)


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
                                        "flash_attention": 0,
                                        "flash_attention_bwd": 0,
                                        "ssd_scan": 0, "ssd_scan_bwd": 0}
    with pytest.raises(ValueError):
        tdispatch.client_histograms(_t(labels), 3, backend="pallas")


# ---------------------------------------------------------------------------
# REPRO_COMPUTE_BACKEND (the reference's process-wide override of "auto")
# ---------------------------------------------------------------------------

def _reference_calls(monkeypatch):
    """Counts of the dispatch's calls into the reference formulas."""
    calls = {"histogram": 0, "masked_mean": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(tdispatch, name, wrapped)

    spy("histogram", tdispatch.histogram)
    spy("masked_mean", tdispatch.masked_mean)
    return calls


def _dispatch_both(labels, valid):
    tree = {k: _t(v) for k, v in _leaves(5, 3).items()}
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    return (tdispatch.client_histograms(_t(labels), 10, _t(valid)),
            tdispatch.masked_weighted_mean(tree, mask))


def test_compute_backend_unset_takes_the_device_path(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)
    calls = _reference_calls(monkeypatch)
    _dispatch_both(*_labels(4, 30, 10, 0))
    monkeypatch.setenv(tdispatch.ENV_VAR, "auto")
    _dispatch_both(*_labels(4, 30, 10, 0))
    assert calls == {"histogram": 0, "masked_mean": 0}


def test_compute_backend_reference_sends_every_dispatch_there(monkeypatch):
    labels, valid = _labels(4, 30, 10, 1)
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)
    want_h, want_m = _dispatch_both(labels, valid)
    monkeypatch.setenv(tdispatch.ENV_VAR, "reference")
    calls = _reference_calls(monkeypatch)
    got_h, got_m = _dispatch_both(labels, valid)
    assert calls == {"histogram": 1, "masked_mean": 1}
    assert torch.equal(got_h, want_h)
    for k in want_m:
        torch.testing.assert_close(got_m[k], want_m[k], rtol=1e-6, atol=1e-6)


def test_compute_backend_reference_raises_on_cuda_tensors(monkeypatch):
    """The variable never sends card tensors past their kernels: every
    dispatch raises on (fake) CUDA tensors before it computes anything."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setenv(tdispatch.ENV_VAR, "reference")
    calls = _reference_calls(monkeypatch)
    with FakeTensorMode():
        labels = torch.zeros(2, 8, dtype=torch.int32, device="cuda")
        tree = {"a": torch.ones(2, 5, device="cuda")}
        w = torch.ones(2, device="cuda")
        for call in (lambda: tdispatch.client_histograms(labels, 10),
                     lambda: tdispatch.masked_weighted_mean(tree, w),
                     lambda: tdispatch.weighted_sum_tree(tree, w)):
            with pytest.raises(RuntimeError, match=tdispatch.ENV_VAR):
                call()
    assert calls == {"histogram": 0, "masked_mean": 0}


@pytest.mark.parametrize("value", ["pallas", "pallas_interpret", "cuda"])
def test_compute_backend_other_values_raise(monkeypatch, value):
    monkeypatch.setenv(tdispatch.ENV_VAR, value)
    labels, valid = _labels(2, 8, 10, 2)
    with pytest.raises(ValueError, match=tdispatch.ENV_VAR):
        tdispatch.client_histograms(_t(labels), 10, _t(valid))
    # An explicit backend does not read the variable.
    tdispatch.client_histograms(_t(labels), 10, _t(valid), backend="reference")
