"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card.

Every test here carries the ``cuda`` marker and skips on a host without a
CUDA device (the kernels have no CPU mode).  The file imports neither JAX nor
the reference, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: histograms bit-equal; the weighted sum within one float32
rounding per client term; float32 attention 2e-5 and the SSD scan 1e-4 (the
reference's own pins, tests/test_kernels.py); bfloat16 attention one bf16 ulp
(both sides round a float32 result once, 2^-7 of the value at most).  The
flash backward kernels against the plain backward within ``BWD_TOL`` of
each gradient's largest magnitude: twice the plain backward's own error in
the input dtype against a float64 plain backward, read by
``chip_smoke.py`` phase 16a (PERF.md); the SSD backward kernels against the
plain vjp of the chunked form and a float64 one within ``SSD_BWD_TOL``, set
by the same rule in phase 16b.  The forward's row logsumexp, which
the bf16 backward reads, within 1e-5 + 1e-6 |L| of the plain one (both sum
float32 exponentials, in other orders).  Gradients of the model on the card
against the CPU within ``GRAD_TOL`` of each leaf's largest magnitude, the
limit that holds the port's gradients to the reference's on the CPU
(tests/test_torch_train.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, FlashAttentionBackward, attention_ref, flash_attention,
    gqa_attention_bwd_ref, gqa_attention_ref, gqa_flash_attention)
from repro_torch.kernels.label_hist import label_hist_kernel, label_hist_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_apply, ssd_apply_ref,  # noqa: E402
                                          ssd_chunked_ref)
from repro_torch.kernels.ssd_scan.backward import launch_backward  # noqa: E402
from repro_torch.kernels.dispatch import masked_weighted_mean  # noqa: E402
from repro_torch.kernels.weighted_agg import (weighted_agg_kernel,  # noqa: E402
                                              weighted_agg_leaves,
                                              weighted_agg_ref)

pytestmark = pytest.mark.cuda

BWD_TOL = {torch.float32: 2.5e-6, torch.bfloat16: 7e-3}
GRAD_TOL = 1e-4
SSD_BWD_TOL = 1.5e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launch_counts()
    return torch.device("cuda")


def _randn(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


def test_label_hist_kernel_bit_equal(cuda):
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(-3, 13, (50, 300)).astype(np.int32))
    valid = torch.from_numpy(rng.random((50, 300)) > 0.1)
    got = label_hist_kernel(labels.to(cuda), valid.to(cuda), 10)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["label_hist"] == 1
    assert torch.equal(got.cpu(), label_hist_ref(labels, valid, 10))


def _hist_inputs(b, n, c, seed, dev):
    rng = np.random.default_rng(seed)
    labels = torch.from_numpy(rng.integers(-3, c + 3, (b, n)).astype(np.int32))
    return labels.to(dev), torch.from_numpy(rng.random((b, n)) > 0.1).to(dev)


# chip_smoke.py phase 3's shapes: the FL round's, the batched grid's (105
# trials x 100 clients), many classes, long rows cut into chunks, C either
# side of 32, n = 0, 1 and 31, rows shared by 8 and by 4 warps, long rows
# with C > 32, and many short rows with C = 16 and 17.
@pytest.mark.parametrize("b,n,c", [
    (100, 290, 10), (10500, 290, 10), (1000, 4096, 62), (8, 1 << 20, 10),
    (64, 1000, 1), (64, 1000, 33), (5, 0, 10), (9, 1, 10), (9, 31, 10),
    (200, 8192, 10), (1000, 4096, 10), (4, 300000, 40), (3, 40000, 10),
    (4400, 100, 16), (4400, 100, 17)])
def test_label_hist_kernel_bit_equal_at_its_edges(cuda, b, n, c):
    labels, valid = _hist_inputs(b, n, c, b + n + c, cuda)
    got = label_hist_kernel(labels, valid, c)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["label_hist"] == 1
    assert torch.equal(got, label_hist_ref(labels, valid, c))


@pytest.mark.parametrize("b,n,c", [(6, 4097, 10), (4500, 33, 16)])
@pytest.mark.parametrize("case", ["row-offset", "labels-alone-at-row-offset",
                                  "invalid-rows", "labels-minus-1-and-C"])
def test_label_hist_kernel_bit_equal_off_alignment_and_range(cuda, case, b, n,
                                                             c):
    labels, valid = _hist_inputs(b, n, c, n, cuda)
    if case == "row-offset":            # rows start off a 16-byte boundary
        labels, valid = labels[1:], valid[1:]
    elif case == "labels-alone-at-row-offset":   # every sample scalar
        labels, valid = labels[1:], _hist_inputs(b - 1, n, c, 1, cuda)[1]
    elif case == "invalid-rows":
        valid[::3] = False
    else:
        labels = torch.where(labels > c // 2, c, -1).to(torch.int32)
    got = label_hist_kernel(labels, valid, c)
    torch.cuda.synchronize()
    assert torch.equal(got, label_hist_ref(labels, valid, c))


@pytest.mark.parametrize("n", [10, 4100])
def test_weighted_agg_kernel_matches(cuda, n):
    x = _randn((30, n), n, cuda)
    w = _randn((30,), n + 1, cuda).abs()
    got = weighted_agg_kernel(x, w)
    want = weighted_agg_ref(x, w)
    torch.cuda.synchronize()
    tol = 2 * 30 * 2.0 ** -24 * (w @ x.abs())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("bh,s,d,dtype,window", [
    (8, 77, 64, torch.float32, 0), (4, 200, 128, torch.float32, 50),
    (16, 256, 128, torch.bfloat16, 0), (16, 256, 64, torch.bfloat16, 64),
    (6, 333, 16, torch.float32, 0), (6, 333, 32, torch.float32, 40),
    (6, 333, 96, torch.float32, 0), (6, 333, 192, torch.float32, 40)])
def test_flash_kernel_matches_plain_version(cuda, bh, s, d, dtype, window):
    q, k, v = (_randn((bh, s, d), s + i, cuda).to(dtype) for i in range(3))
    got = flash_attention(q, k, v, window=window).float()
    want = attention_ref(q, k, v, True, window).float()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    tol = (2e-5 * (1 + want.abs()) if dtype == torch.float32
           else 2.0 ** -7 * want.abs() + 1e-5)
    assert bool(((got - want).abs() <= tol).all())


def test_weighted_agg_tree_is_one_launch(cuda):
    sizes = [288, 32, 18432, 64, 401408, 128, 1280, 10]   # the paper CNN
    xs = [_randn((30, n), n, cuda) for n in sizes]
    w = _randn((30,), 1, cuda).abs()
    mask = (_randn((30,), 2, cuda) > 0).float()
    sums = weighted_agg_leaves(xs, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["weighted_agg"] == 1
    for x, got in zip(xs, sums):
        tol = 2 * 30 * 2.0 ** -24 * (w @ x.abs())
        assert bool(((got - weighted_agg_ref(x, w)).abs() <= tol).all())
    tree = {f"leaf{i}": x for i, x in enumerate(xs)}
    means = masked_weighted_mean(tree, mask, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["weighted_agg"] == 2
    ww = mask * w
    denom = torch.clamp(ww.sum(), min=1e-12)
    for (name, x), got in zip(tree.items(), means.values()):
        want = weighted_agg_ref(x, ww, denom)
        tol = (2 * 30 * 2.0 ** -24 * (ww @ x.abs()) / denom
               + 2.0 ** -23 * want.abs())
        assert bool(((got - want).abs() <= tol).all()), name
    bf = weighted_agg_leaves([x.bfloat16() for x in xs[:3]] + xs[3:], w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["weighted_agg"] == 4   # one a dtype
    assert [y.dtype for y in bf[:3]] == [torch.bfloat16] * 3


@pytest.mark.parametrize("trials", [1, 21, 105])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_agg_trial_axis_bit_equal_to_per_trial_launches(cuda, trials,
                                                                 dtype):
    """The grid engine's reduction: leaves (T, K, N) with weights (T, K) and
    a denominator a trial in one launch, bit-equal to T one-trial launches;
    ragged leaf sizes (scalar and 16-byte paths) and the paper CNN's."""
    sizes = [288, 32, 18432, 64, 4013, 128, 1280, 10, 7]
    k = 30
    xs = [_randn((trials, k, n), n + trials, cuda).to(dtype) for n in sizes]
    w = _randn((trials, k), trials, cuda).abs()
    denom = torch.clamp(w.sum(-1), min=1e-12)
    kernels.reset_launch_counts()
    got = weighted_agg_leaves(xs, w, denom)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["weighted_agg"] == 1
    for t in range(trials):
        one = weighted_agg_leaves([x[t] for x in xs], w[t], denom[t:t + 1])
        for y, y1 in zip(got, one):
            assert y.dtype == dtype and torch.equal(y[t], y1)
    for x, y in zip(xs, got):
        want = weighted_agg_ref(x, w, denom).float()
        tol = (2 * k * 2.0 ** -24 * torch.einsum("tk,tkn->tn", w,
                                                  x.float().abs())
               / denom[:, None] + 2.0 ** -23 * want.abs())
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * want.abs()
        assert bool(((y.float() - want).abs() <= tol).all())


def test_weighted_agg_trial_axis_one_client(cuda):
    """K = 1: every trial's sum is its one client scaled, divided."""
    xs = [_randn((21, 1, n), n, cuda) for n in (33, 4096)]
    w = _randn((21, 1), 5, cuda).abs() + 0.5
    got = weighted_agg_leaves(xs, w, w[:, 0])
    torch.cuda.synchronize()
    for t in range(21):
        one = weighted_agg_leaves([x[t] for x in xs], w[t], w[t])
        assert all(torch.equal(y[t], y1) for y, y1 in zip(got, one))
    for x, y in zip(xs, got):
        torch.testing.assert_close(y, x[:, 0], rtol=2.0 ** -22, atol=0)


def test_masked_weighted_mean_trial_axis_is_one_launch(cuda):
    """``dispatch.masked_weighted_mean`` with a trial axis: one launch for
    the tree and every trial, each trial equal to its own call."""
    tree = {"w": _randn((21, 30, 8, 4), 1, cuda),
            "b": _randn((21, 30, 4), 2, cuda)}
    mask = (_randn((21, 30), 3, cuda) > 0).float()
    mask[4] = 0.0                                # an empty selection
    sizes = _randn((21, 30), 4, cuda).abs() * 100
    kernels.reset_launch_counts()
    got = masked_weighted_mean(tree, mask, sizes)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["weighted_agg"] == 1
    for t in range(21):
        one = masked_weighted_mean({k: v[t] for k, v in tree.items()},
                                   mask[t], sizes[t])
        for k in tree:
            assert torch.equal(got[k][t], one[k]), (t, k)


@pytest.mark.parametrize("rows", [32, 256, 1 << 16])
def test_label_hist_kernel_bit_equal_at_population_shapes(cuda, rows):
    """The population round's histograms, 8 samples a client: the selected
    rows (32), one block (256) and a chunk of 256 blocks (65536), on the
    procedural plan's labels and on random labels with padding."""
    from repro_torch.fl import synthetic_population_plan
    from repro_torch.rng import PRNGKey
    plan = synthetic_population_plan(samples_per_client=8)(
        PRNGKey(rows, cuda), torch.arange(rows, device=cuda))
    cases = [(plan, plan >= 0), _hist_inputs(rows, 8, 10, rows, cuda)]
    for labels, valid in cases:
        kernels.reset_launch_counts()
        got = label_hist_kernel(labels, valid, 10)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["label_hist"] == 1
        assert torch.equal(got, label_hist_ref(labels, valid, 10))


def test_weighted_agg_async_window_bit_equal_to_per_arrival_launches(cuda):
    """The async engine's window: K = 10 arrivals on the trial axis, 10
    clients each, over the paper CNN's leaves, one arrival with no live
    client; one launch, each arrival bit-equal to its own launch and within
    the float32 bound of the plain version."""
    from repro_torch.models import cnn_init
    sizes = [v.numel() for v in cnn_init(device=cuda).values()]
    xs = [_randn((10, 10, n), n, cuda) for n in sizes]
    w = _randn((10, 10), 7, cuda).abs() * 100
    w[3] = 0.0
    denom = torch.clamp(w.sum(-1), min=1e-12)
    kernels.reset_launch_counts()
    got = weighted_agg_leaves(xs, w, denom)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["weighted_agg"] == 1
    for t in range(10):
        one = weighted_agg_leaves([x[t] for x in xs], w[t], denom[t:t + 1])
        assert all(torch.equal(y[t], y1) for y, y1 in zip(got, one))
    for x, y in zip(xs, got):
        want = weighted_agg_ref(x, w, denom)
        tol = (2 * 10 * 2.0 ** -24 * torch.einsum("tk,tkn->tn", w, x.abs())
               / denom[:, None] + 2.0 ** -23 * want.abs())
        assert bool(((y - want).abs() <= tol).all())
        assert not bool(y[3].any())


def test_weighted_agg_splits_past_the_table(cuda):
    # 200 leaves, 190 of them non-empty: three tables of at most 64, block
    # starts from 0 in each; odd sizes take scalar loads.
    sizes = [(i % 7) * 300 + i % 3 for i in range(200)]
    assert sum(n > 0 for n in sizes) == 190
    xs = [_randn((5, n), n + i, cuda) for i, n in enumerate(sizes)]
    w = _randn((5,), 3, cuda)
    sums = weighted_agg_leaves(xs, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["weighted_agg"] == 3
    for x, got in zip(xs, sums):
        tol = 2 * 5 * 2.0 ** -24 * (w.abs() @ x.abs())
        assert bool(((got - weighted_agg_ref(x, w)).abs() <= tol).all())


@pytest.mark.parametrize("bh,s,d,causal,window", [
    (8, 77, 64, True, 0), (8, 1000, 128, True, 0), (8, 1000, 128, True, 256),
    (8, 77, 64, False, 0), (8, 1000, 128, False, 0)])
def test_bf16_flash_kernel_edges(cuda, bh, s, d, causal, window):
    q, k, v = (_randn((bh, s, d), s + d + i, cuda).bfloat16()
               for i in range(3))
    got = flash_attention(q, k, v, causal=causal, window=window).float()
    want = attention_ref(q, k, v, causal, window).float()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5).all())


# head_dim 192 (nemotron-4-340b), three 64-column slabs of the bf16 kernel:
# causal, windowed, without the mask, at an S of no multiple of either tile;
# float32 (the tensor-core kernels in split TF32) likewise.
@pytest.mark.parametrize("bh,s,dtype,causal,window", [
    (8, 1000, torch.bfloat16, True, 0), (8, 1000, torch.bfloat16, True, 256),
    (8, 77, torch.bfloat16, False, 0), (4, 333, torch.bfloat16, True, 40),
    (4, 333, torch.float32, True, 40), (4, 77, torch.float32, False, 0)])
def test_flash_kernel_at_head_dim_192(cuda, bh, s, dtype, causal, window):
    q, k, v = (_randn((bh, s, 192), s + i, cuda).to(dtype) for i in range(3))
    got = flash_attention(q, k, v, causal=causal, window=window).float()
    want = attention_ref(q, k, v, causal, window).float()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    tol = (2e-5 * (1 + want.abs()) if dtype == torch.float32
           else 2.0 ** -7 * want.abs() + 1e-5)
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqa_kernel_at_head_dim_192_group_of_12(cuda, dtype):
    """nemotron-4-340b's 96 q-heads over 8 kv-heads, with a lse for the
    backward that the output does not depend on."""
    q = _randn((1, 333, 96, 192), 7, cuda).to(dtype)
    k, v = (_randn((1, 333, 8, 192), i, cuda).to(dtype) for i in (8, 9))
    got = gqa_flash_attention(q, k, v).float()
    want = gqa_attention_ref(q, k, v).float()
    o, lse = FlashAttention.apply(q, k, v, True, 0, True)
    torch.cuda.synchronize()
    tol = (2e-5 * (1 + want.abs()) if dtype == torch.float32
           else 2.0 ** -7 * want.abs() + 1e-5)
    assert bool(((got - want).abs() <= tol).all())
    assert torch.equal(o.float(), got)
    assert lse.shape == (1, 96, 333) and bool(torch.isfinite(lse).all())


# head_dim 96 (phi-3-vision-4.2b), three 32-column slabs under the 64-byte
# swizzle in bf16: causal, windowed and without the mask, at an S of no
# multiple of 64 or 128; float32 (split TF32) likewise.
@pytest.mark.parametrize("bh,s,causal,window", [
    (8, 1000, True, 0), (8, 333, True, 40), (8, 1000, True, 256),
    (8, 77, False, 0), (6, 1500, False, 0), (4, 2048, True, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_at_head_dim_96(cuda, bh, s, dtype, causal, window):
    q, k, v = (_randn((bh, s, 96), s + 96 + i, cuda).to(dtype)
               for i in range(3))
    got = flash_attention(q, k, v, causal=causal, window=window).float()
    want = attention_ref(q, k, v, causal, window).float()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    tol = (2e-5 * (1 + want.abs()) if dtype == torch.float32
           else 2.0 ** -7 * want.abs() + 1e-5)
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_noncausal_kernel_at_whisper_encoder_shape(cuda, dtype):
    """whisper-tiny's encoder, (16, 1500, 6/6, 64) without the causal mask:
    11 full 128-row tiles and a 92-row edge, the keys past S masked; and
    phi-3-vision's 32 heads of 96 through the GQA wrapper, causal."""
    q, k, v = (_randn((16, 1500, 6, 64), 30 + i, cuda).to(dtype)
               for i in range(3))
    got = gqa_flash_attention(q, k, v, causal=False).float()
    want = gqa_attention_ref(q, k, v, causal=False).float()
    q96 = _randn((1, 333, 32, 96), 40, cuda).to(dtype)
    got96 = gqa_flash_attention(q96, q96, q96).float()
    want96 = gqa_attention_ref(q96, q96, q96).float()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 2
    for g, w in ((got, want), (got96, want96)):
        tol = (2e-5 * (1 + w.abs()) if dtype == torch.float32
               else 2.0 ** -7 * w.abs() + 1e-5)
        assert bool(((g - w).abs() <= tol).all())


def test_backward_refuses_a_head_dim_the_kernels_do_not_take(cuda):
    """A head_dim outside the kernels' raises on the card before any
    launch: no path gives way to the plain backward."""
    from repro_torch.kernels.flash_attention.backward import launch_backward
    for dtype in (torch.bfloat16, torch.float32):
        x = _randn((1, 64, 4, 48), 1, cuda).to(dtype)
        lse = torch.zeros((1, 4, 64), device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            FlashAttentionBackward.apply(x, x, x, x, lse, x, True, 0)
        with pytest.raises(ValueError, match="head_dim"):
            launch_backward(x, x, x, x, lse, x, causal=True, window=0)
    assert kernels.launch_counts()["flash_attention_bwd"] == 0


def test_bf16_gqa_kernel_matches_plain_version(cuda):
    q = _randn((2, 333, 40, 128), 4, cuda).bfloat16()
    k = _randn((2, 333, 8, 128), 5, cuda).bfloat16()
    v = _randn((2, 333, 8, 128), 6, cuda).bfloat16()
    got = gqa_flash_attention(q, k, v).float()
    want = gqa_attention_ref(q, k, v).float()
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5).all())


def test_gqa_kernel_matches_plain_version(cuda):
    q = _randn((2, 100, 8, 64), 1, cuda)
    k, v = _randn((2, 100, 2, 64), 2, cuda), _randn((2, 100, 2, 64), 3, cuda)
    got = gqa_flash_attention(q, k, v)
    want = gqa_attention_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,s,h,g,p,n", [(2, 64, 4, 2, 8, 64),
                                         (1, 96, 16, 1, 32, 32),
                                         (1, 256, 8, 1, 64, 128)])
def test_ssd_kernel_matches_plain_version(cuda, b, s, h, g, p, n):
    x = _randn((b, s, h, p), 1, cuda)
    dt = torch.nn.functional.softplus(_randn((b, s, h), 2, cuda))
    A = -torch.exp(0.3 * _randn((h,), 3, cuda))
    B, C = 0.5 * _randn((b, s, g, n), 4, cuda), 0.5 * _randn((b, s, g, n), 5, cuda)
    y, fin = ssd_apply(x, dt, A, B, C, chunk=32)
    y_ref, fin_ref = ssd_apply_ref(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_scan"] == 1
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fin, fin_ref, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_strong_decay_stays_finite_and_close(cuda):
    # dt up to 10 and A near -10: the log-decay sum inside one of the
    # kernel's chunks reaches thousands, where exp(cum_t - cum_s) taken as a
    # difference of running sums would lose the 1e-4.
    rng = np.random.default_rng(7)
    b, s, h, g, p, n = 1, 2048, 4, 1, 64, 128
    x = _randn((b, s, h, p), 11, cuda)
    dt = torch.from_numpy(rng.uniform(0, 10, (b, s, h)).astype(np.float32)).to(cuda)
    A = torch.from_numpy(
        (-10 * np.exp(0.1 * rng.standard_normal(h))).astype(np.float32)).to(cuda)
    B, C = 0.5 * _randn((b, s, g, n), 12, cuda), 0.5 * _randn((b, s, g, n), 13, cuda)
    y, fin = ssd_apply(x, dt, A, B, C, chunk=128)
    y_ref, fin_ref = ssd_apply_ref(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fin, fin_ref, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_is_deterministic(cuda):
    x = _randn((1, 256, 8, 64), 21, cuda)
    dt = torch.nn.functional.softplus(_randn((1, 256, 8), 22, cuda))
    A = -torch.exp(0.3 * _randn((8,), 23, cuda))
    B, C = 0.5 * _randn((1, 256, 1, 128), 24, cuda), 0.5 * _randn((1, 256, 1, 128), 25, cuda)
    y1, fin1 = ssd_apply(x, dt, A, B, C, chunk=128)
    y2, fin2 = ssd_apply(x, dt, A, B, C, chunk=128)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_scan"] == 2
    assert torch.equal(y1, y2) and torch.equal(fin1, fin2)


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [
    (2, 80, 6, 2, 8, 16, 16),      # three heads a group, P = 8, N = 16
    (1, 100, 3, 1, 40, 24, 20),    # odd heads, P and N below their tiles
    (1, 64, 2, 2, 128, 72, 32)])   # P over one block's 64 rows, N = 72
def test_ssd_kernel_groups_narrow_heads_and_a_ragged_tail(cuda, b, s, h, g,
                                                          p, n, chunk):
    # S is no multiple of the kernel's 32-step chunk in the first two cases,
    # so the last chunk is part padding; G, P and N land off the kernel's
    # tiles (two heads a block, 64 rows a head, N padded to 16/32/64/128).
    x = _randn((b, s, h, p), 31, cuda)
    dt = torch.nn.functional.softplus(_randn((b, s, h), 32, cuda))
    A = -torch.exp(0.3 * _randn((h,), 33, cuda))
    B, C = 0.5 * _randn((b, s, g, n), 34, cuda), 0.5 * _randn((b, s, g, n), 35, cuda)
    y, fin = ssd_apply(x, dt, A, B, C, chunk=chunk)
    y_ref, fin_ref = ssd_apply_ref(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_scan"] == 1
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fin, fin_ref, rtol=1e-4, atol=1e-4)


def _ssd_bwd_inputs(b, s, h, g, p, n, seed, dev, decaying=False):
    """x, dt, A (H,), B, C as tests/test_kernels.py draws them, and the
    output gradients gy and gfin; ``decaying``: dt up to 10, A near -10."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    if decaying:
        dt = rng.uniform(0, 10, (b, s, h))
        A = -10 * np.exp(0.1 * rng.standard_normal(h))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
        A = -np.exp(0.3 * rng.standard_normal(h))
    B, C = (0.5 * rng.standard_normal((b, s, g, n)) for _ in range(2))
    gy, gfin = rng.standard_normal((b, s, h, p)), rng.standard_normal(
        (b, h, p, n))
    return [torch.from_numpy(v.astype(np.float32)).to(dev)
            for v in (x, dt, A, B, C, gy, gfin)]


def _ssd_function_grads(x, dt, A, B, C, gy, gfin, chunk):
    """The gradients of (y, final_state) through ``ssd_apply``'s Function."""
    ts = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, fin = ssd_apply(*ts, chunk=chunk)
    torch.autograd.backward((y, fin), (gy, gfin))
    return [t.grad for t in ts]


def _ssd_plain_grads(x, dt, A, B, C, gy, gfin, chunk, dtype):
    _, vjp = torch.func.vjp(lambda *a: ssd_chunked_ref(*a, chunk),
                            *(t.to(dtype) for t in (x, dt, A, B, C)))
    return vjp((gy.to(dtype), gfin.to(dtype)))


def _grad_gap(got, want):
    return max(((g.double() - w.double()).abs().max()
                / w.double().abs().max()).item() for g, w in zip(got, want))


# chip_smoke.py phase 16b's small shapes: three heads a group with a ragged
# tail, P 4 and N 16, P 68 (two 64-row slabs) and N 72 at S 16, and S 1000
# (no multiple of the kernels' chunks of 32 and 64 steps); then the
# head-summed pass at its edges: 64 heads in one group (mamba2-1.3b's head
# count summed inside the kernel), groups of three heads (an odd count,
# shared by a cluster of blocks), S 96 (no multiple of the 64-step chunk).
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [(2, 80, 6, 2, 8, 16, 16),
                                               (2, 64, 4, 2, 4, 16, 32),
                                               (1, 16, 3, 1, 68, 72, 16),
                                               (1, 1000, 4, 1, 64, 128, 8),
                                               (1, 128, 64, 1, 64, 128, 64),
                                               (2, 192, 6, 2, 64, 32, 64),
                                               (1, 96, 4, 1, 64, 64, 32)])
def test_ssd_backward_kernel_matches_plain_vjp(cuda, b, s, h, g, p, n, chunk):
    args = _ssd_bwd_inputs(b, s, h, g, p, n, s + h, cuda)
    got = _ssd_function_grads(*args, chunk)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["ssd_scan"], counts["ssd_scan_bwd"]) == (1, 1)
    for dtype in (torch.float32, torch.float64):
        assert _grad_gap(got, _ssd_plain_grads(*args, chunk, dtype)) \
            <= SSD_BWD_TOL


def test_ssd_backward_kernel_strong_decay(cuda):
    # dt up to 10 and A near -10 over 2048 steps: the plain form is taken at
    # chunk 1, where no exponent is a difference of running sums.
    args = _ssd_bwd_inputs(1, 2048, 4, 1, 64, 128, 9, cuda, decaying=True)
    got = _ssd_function_grads(*args, 128)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for dtype in (torch.float32, torch.float64):
        assert _grad_gap(got, _ssd_plain_grads(*args, 1, dtype)) \
            <= SSD_BWD_TOL


# Two calls give the same bits, also with 64 heads summed in one group.
@pytest.mark.parametrize("b,s,h", [(2, 256, 8), (1, 128, 64)])
def test_ssd_backward_kernel_is_deterministic(cuda, b, s, h):
    x, dt, A, B, C, gy, gfin = _ssd_bwd_inputs(b, s, h, 1, 64, 128, 3, cuda)
    A2 = A.expand(b, h).contiguous()
    one = launch_backward(x, dt, A2, B, C, gy, gfin)
    two = launch_backward(x, dt, A2, B, C, gy, gfin)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_scan_bwd"] == 2
    assert all(torch.equal(a, b_) for a, b_ in zip(one, two))


def test_ssd_vmap_grad_over_clients_is_one_backward_launch(cuda):
    """vmap(grad(...)) of the SSD Function over 6 clients equals 6 separate
    calls, with one forward and one backward launch for all of them."""
    from torch.func import grad, vmap
    per = [_ssd_bwd_inputs(2, 64, 4, 2, 8, 16, 40 + i, cuda) for i in range(6)]
    x, dt, B, C = (torch.stack([a[j] for a in per]) for j in (0, 1, 3, 4))
    A, gy, gfin = per[0][2], per[0][5], per[0][6]

    def loss(x, dt, B, C):
        y, fin = ssd_apply(x, dt, A, B, C, chunk=16)
        return (y * gy).sum() + (fin * gfin).sum()

    batched = vmap(grad(loss, argnums=(0, 1, 2, 3)))(x, dt, B, C)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["ssd_scan"], counts["ssd_scan_bwd"]) == (1, 1)
    for i in range(6):
        one = grad(loss, argnums=(0, 1, 2, 3))(x[i], dt[i], B[i], C[i])
        for a, b_ in zip(batched, one):
            torch.testing.assert_close(a[i], b_, rtol=1e-5, atol=1e-6)


def test_ssd_backward_refuses_what_it_does_not_take(cuda):
    x, dt, A, B, C, gy, gfin = _ssd_bwd_inputs(1, 32, 2, 1, 4, 16, 0, cuda)
    A2 = A.expand(1, 2).contiguous()
    with pytest.raises(ValueError, match="N in"):      # N = 12
        launch_backward(x, dt, A2, B[..., :12].contiguous(),
                        C[..., :12].contiguous(), gy, gfin[..., :12]
                        .contiguous())
    with pytest.raises(ValueError, match="P a multiple"):   # P = 6
        x6 = torch.zeros((1, 32, 2, 6), device=cuda)
        launch_backward(x6, dt, A2, B, C, x6, torch.zeros(
            (1, 2, 6, 16), device=cuda))
    with pytest.raises(TypeError):                       # float64
        launch_backward(*(t.double() for t in (x, dt, A2, B, C, gy, gfin)))
    assert kernels.launch_counts()["ssd_scan_bwd"] == 0


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = _randn((2, 16, 48), 0, cuda)          # head_dim 48: not in HEAD_DIMS
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    x = _randn((1, 32, 2, 4), 0, cuda)
    B = _randn((1, 32, 1, 12), 1, cuda)       # N = 12: no multiple of 8
    with pytest.raises(ValueError, match="N in"):
        ssd_apply(x, x[..., 0].abs(), -x[0, 0, :, 0].abs(), B, B, chunk=32)


# (B, S, H, KV, D, dtype, causal, window): qwen3-14b's prefill shape in
# bf16, causal and windowed; float32 at every head dim, GQA groups 1, 2 and
# 5, ragged S (no multiple of the 64-row or 32-key tiles), a window shorter
# than a tile and no causal mask; bf16 (the tensor-core kernels) also at
# head_dim 64, GQA groups 1 and 8, S of no multiple of 64 or 128, no causal
# mask (with and without a window) and windows shorter than a tile, and
# whisper-tiny's full-width training shapes: the encoder's 1500 frames
# non-causal (a 92-row edge tile) and the decoder's 448 tokens causal.
BWD_SHAPES = [
    (4, 1024, 40, 8, 128, torch.bfloat16, True, 0),
    (4, 1024, 40, 8, 128, torch.bfloat16, True, 256),
    (2, 77, 10, 10, 16, torch.float32, True, 0),
    (2, 77, 10, 5, 32, torch.float32, True, 5),
    (2, 130, 10, 2, 64, torch.float32, True, 0),
    (1, 130, 4, 2, 128, torch.float32, False, 0),
    (2, 77, 10, 2, 16, torch.float32, False, 7),
    (1, 333, 10, 2, 128, torch.bfloat16, True, 40),
    (2, 77, 8, 1, 64, torch.bfloat16, True, 0),
    (1, 190, 6, 6, 64, torch.bfloat16, False, 0),
    (2, 300, 16, 2, 128, torch.bfloat16, True, 20),
    (1, 257, 4, 2, 128, torch.bfloat16, False, 33),
    (16, 1500, 6, 6, 64, torch.bfloat16, False, 0),
    (16, 448, 6, 6, 64, torch.bfloat16, True, 0),
    # head_dim 96 (phi-3-vision-4.2b's training shape at full width) and
    # 192 (nemotron-4-340b's prefill shape), then each windowed and with S
    # of no multiple of 64, and not causal; the float32 pair at both.
    (4, 2048, 32, 32, 96, torch.bfloat16, True, 0),
    (4, 1024, 96, 8, 192, torch.bfloat16, True, 0),
    (1, 333, 8, 2, 96, torch.bfloat16, True, 40),
    (1, 333, 12, 2, 192, torch.bfloat16, True, 40),
    (1, 190, 6, 6, 96, torch.bfloat16, False, 0),
    (1, 257, 4, 2, 192, torch.bfloat16, False, 33),
    (2, 77, 8, 4, 96, torch.float32, True, 0),
    (1, 130, 4, 2, 96, torch.float32, False, 0),
    (2, 77, 6, 2, 192, torch.float32, True, 9),
    (1, 130, 4, 2, 192, torch.float32, False, 0),
    # The float32 kernels (tensor cores, split TF32) at every head_dim:
    # causal with a GQA group of 8, windowed with a group of 1, not causal
    # with a group of 3, each at an S of no multiple of their tiles.
] + [(b, s, h, kv, d, torch.float32, causal, window)
     for d in (16, 32, 64, 96, 128, 192)
     for b, s, h, kv, causal, window in ((1, 133, 16, 2, True, 0),
                                         (2, 77, 4, 4, True, 20),
                                         (1, 100, 6, 2, False, 0))]


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("b,s,h,kv,d,dtype,causal,window", BWD_SHAPES)
def test_flash_backward_kernels_match_plain_backward(cuda, b, s, h, kv, d,
                                                     dtype, causal, window):
    q = _randn((b, s, h, d), 1, cuda).to(dtype)
    k, v = (_randn((b, s, kv, d), i, cuda).to(dtype) for i in (2, 3))
    do = _randn((b, s, h, d), 4, cuda).to(dtype)
    o, lse = FlashAttention.apply(q, k, v, causal, window, True)
    got = FlashAttentionBackward.apply(q, k, v, o, lse, do, causal, window)
    want = gqa_attention_bwd_ref(q, k, v, o, do, causal, window)
    exact = gqa_attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                                  causal, window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, exact):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_err(g, w) <= BWD_TOL[dtype], name
        assert _rel_err(g, e) <= BWD_TOL[dtype], name
    if dtype == torch.float32:     # the forward it read, as phase 8 holds it
        plain = gqa_attention_ref(q, k, v, causal, window)
        assert bool(((o - plain).abs() <= 2e-5 * (1 + plain.abs())).all())


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", [
    (2, 333, 10, 2, 128, True, 0), (1, 300, 16, 2, 64, True, 40),
    (1, 257, 6, 6, 192, False, 0), (2, 130, 8, 1, 16, True, 0)])
def test_f32_flash_backward_repeats_bit_identical(cuda, b, s, h, kv, d,
                                                  causal, window):
    """Every float32 gradient element is summed by one thread of one block
    (no atomics), so repeat calls give the same bits."""
    q = _randn((b, s, h, d), 1, cuda)
    k, v = (_randn((b, s, kv, d), i, cuda) for i in (2, 3))
    do = _randn((b, s, h, d), 4, cuda)
    o, lse = FlashAttention.apply(q, k, v, causal, window, True)
    first = FlashAttentionBackward.apply(q, k, v, o, lse, do, causal, window)
    for _ in range(2):
        again = FlashAttentionBackward.apply(q, k, v, o, lse, do, causal,
                                             window)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("b,s,h,kv,d,dtype,causal,window", [
    (2, 333, 40, 8, 128, torch.bfloat16, True, 0),
    (1, 190, 6, 6, 64, torch.bfloat16, False, 33),
    (2, 77, 10, 5, 32, torch.float32, True, 5)])
def test_forward_lse_leaves_output_bit_identical(cuda, b, s, h, kv, d, dtype,
                                                 causal, window):
    """The forward writes each row's logsumexp only when asked, and its
    output is the same bits either way; L matches the plain logsumexp."""
    from repro_torch.kernels.flash_attention.flash_attention import launch
    q = _randn((b, s, h, d), 1, cuda).to(dtype)
    k, v = (_randn((b, s, kv, d), i, cuda).to(dtype) for i in (2, 3))
    plain = launch(q, k, v, causal=causal, window=window)
    o, lse = launch(q, k, v, causal=causal, window=window, with_lse=True)
    _, want = gqa_attention_ref(q, k, v, causal, window, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(plain, o)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


def _lm_grads(arch, device):
    """Gradients of forward + token_ce of a reduced float32 model, weights
    from PRNGKey(3) made on the CPU, at ``device``."""
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model, token_ce
    from repro_torch.models.transformer import (flatten_params,
                                                unflatten_params)
    cfg = get_config(arch).reduced(dtype="float32")
    flat = flatten_params(init_model(rng.PRNGKey(3), cfg, device="cpu"))
    g = np.random.default_rng(3)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (2, 40)))
    targets = torch.roll(toks, -1, 1)
    targets[:, -1] = -1
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:      # the encoder's frames, non-causal
        batch["frames"] = torch.from_numpy(g.standard_normal(
            (2, cfg.num_frames, cfg.d_model)).astype(np.float32))

    def loss(p):
        logits, _ = forward(unflatten_params(p), cfg,
                            {k: v.to(device) for k, v in batch.items()})
        return token_ce(logits, targets.to(device))[0]

    grads = torch.func.grad(loss)({k: v.to(device) for k, v in flat.items()})
    return {k: g.cpu() for k, g in grads.items()}


@pytest.mark.parametrize("arch,leaves", [
    ("qwen3-14b", ("attn.wq", "attn.wk", "attn.wv")),
    ("mamba2-1.3b", ("mamba.in_proj", "mamba.A_log", "mamba.dt_bias")),
    ("whisper-tiny", ("attn.wq", "attn.wk", "cross_attn.wq",
                      "cross_attn.wv"))])
def test_model_gradients_on_the_card_match_the_cpu(cuda, arch, leaves):
    """The attention and SSD branches carry their gradients on the card
    (the kernels' outputs had no grad_fn before they became
    autograd.Functions, which left these leaves' gradients zero); whisper's
    through its encoder's non-causal backward and its plain
    cross-attention."""
    got = _lm_grads(arch, cuda)
    counts = kernels.launch_counts()
    want = _lm_grads(arch, torch.device("cpu"))
    assert counts["ssd_scan" if arch == "mamba2-1.3b"
                  else "flash_attention_bwd"] >= 2
    for name in got:
        scale = want[name].abs().max().item()
        assert (got[name] - want[name]).abs().max().item() <= GRAD_TOL * scale
    for name in (n for n in got if n.endswith(leaves)):
        assert want[name].abs().max().item() > 0, name


def test_vmap_grad_over_clients_is_one_launch_each_way(cuda):
    """vmap(grad(...)) over 6 clients equals 6 separate calls, and the flash
    kernels launch once each way for all of them."""
    from torch.func import grad, vmap
    q = _randn((6, 2, 40, 4, 16), 5, cuda)
    k, v = _randn((6, 2, 40, 2, 16), 6, cuda), _randn((6, 2, 40, 2, 16), 7,
                                                      cuda)
    w = _randn((2, 40, 4, 16), 8, cuda)

    def loss(q, k, v):
        return (gqa_flash_attention(q, k, v, window=9) * w).sum()

    batched = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (1, 1)
    for i in range(6):
        one = grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i])
        for a, b_ in zip(batched, one):
            torch.testing.assert_close(a[i], b_, rtol=1e-5, atol=1e-6)


def test_label_hist_ops_client_statistics_launches_the_kernel(cuda):
    """``label_hist.ops.client_statistics`` on the card: one ``label_hist``
    launch, histograms and scores bit-equal to the CPU's plain version."""
    from repro_torch.kernels.label_hist.ops import client_statistics
    rng = np.random.default_rng(11)
    labels = torch.from_numpy(rng.integers(0, 10, (100, 290)).astype(
        np.int32))
    labels[torch.from_numpy(rng.random((100, 290)) < 0.2)] = -1
    labels[3] = -1
    got_h, got_s = client_statistics(labels.to(cuda), 10)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["label_hist"] == 1
    want_h, want_s = client_statistics(labels, 10)
    assert torch.equal(got_h.cpu(), want_h)
    assert torch.equal(got_s.cpu(), want_s)


def _moe_case(cfg, b, s, dev, seed):
    """``moe_init`` of ``cfg`` from PRNGKey(seed) on the CPU, and x (b, s, d)
    and a loss weight from NumPy, all moved to ``dev``."""
    from repro_torch import rng
    from repro_torch.models.layers import moe_init
    p = {k: v.to(dev) for k, v in moe_init(rng.PRNGKey(seed), cfg).items()}
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.standard_normal((b, s, cfg.d_model)).astype(
        np.float32)).to(dev, getattr(torch, cfg.dtype))
    w = torch.from_numpy(g.standard_normal((b, s, cfg.d_model)).astype(
        np.float32)).to(dev)
    return p, x, w


def _moe_grads(p, x, w, cfg):
    """``moe_apply``'s (y, aux) and the gradients of sum(y·w) + 3·aux in x
    and every leaf."""
    from repro_torch.models.layers import moe_apply
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    xx = x.detach().requires_grad_()
    y, aux = moe_apply(leaves, xx, cfg)
    grads = torch.autograd.grad((y.float() * w).sum() + 3.0 * aux,
                                [xx] + list(leaves.values()))
    return [y.detach(), aux.detach()] + list(grads)


def test_moe_capacity_is_bit_identical_run_to_run(cuda):
    """granite-moe-1b-a400m's MoE layer at its training shape (t = 4096,
    E = 32, top 8, d 1024, bf16, capacity routing): forward and backward
    twice, every output and gradient bit-equal (the combine and the
    dispatch's backward add a token's k rows in a fixed order)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.layers import moe_capacity
    cfg = get_config("granite-moe-1b-a400m")
    assert (cfg.num_experts, cfg.experts_per_token, cfg.d_model,
            cfg.dtype, cfg.moe_dropless) == (32, 8, 1024, "bfloat16", False)
    p, x, w = _moe_case(cfg, 4, 1024, cuda, 0)
    first = _moe_grads(p, x, w, cfg)
    second = _moe_grads(p, x, w, cfg)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    # A hot expert (capacity factor 0.5, expert 0 favoured) drops tokens;
    # the dropped rows' zero weights change no bit either.
    hot = dataclasses.replace(cfg, capacity_factor=0.5)
    p["router"][:, 0] += 0.05
    assert moe_capacity(hot, 4096) < 4096 * 8 // 32
    first = _moe_grads(p, x, w, hot)
    second = _moe_grads(p, x, w, hot)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def test_moe_capacity_card_matches_cpu_float32(cuda):
    """A reduced granite-moe layer with capacity routing (8 experts, top 2,
    a hot expert that drops tokens), float32 with TF32 off: output and
    gradients on the card within ``GRAD_TOL`` of each one's largest
    magnitude of the CPU's."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(
        dtype="float32"), num_experts=8, experts_per_token=2,
        capacity_factor=0.5, moe_dropless=False)
    p, x, w = _moe_case(cfg, 2, 40, torch.device("cpu"), 1)
    p["router"][:, 0] += 0.05
    want = _moe_grads(p, x, w, cfg)
    got = _moe_grads({k: v.to(cuda) for k, v in p.items()}, x.to(cuda),
                     w.to(cuda), cfg)
    for a, b_ in zip(got, want):
        scale = b_.abs().max().item()
        assert (a.cpu() - b_).abs().max().item() <= GRAD_TOL * max(scale,
                                                                   1e-30)
