"""The port's FL round against the JAX reference's, end to end on the CPU.

Two consecutive rounds of ``make_fl_round`` run in both stacks at a micro
size (6 clients, 3 per round, 1 local epoch, batch 8, a narrow CNN) on the
same NumPy-made batches and the same reference init, carried over by
``params_from_jax``.  Each stack carries its own params into round 2.

* Histograms, ``selected``, ``live``, ``mask`` and ``num_selected`` are equal.
* The params agree to rtol 1e-5 / atol 1e-6, with ``optimizer="sgd"``
  (FedAvg and FedSGD) and with Adam alike.  Adam could need more: it divides
  each coordinate's first moment by the root of its second, so where a
  gradient coordinate is near zero, a last-bit difference (the two stacks sum
  convolutions in different orders) can move that coordinate's update by up
  to the learning rate.  Measured here, it does not: the largest absolute
  difference after either round is 6.0e-8 with Adam, 8.9e-8 with sgd (largest
  relative 2.8e-6 and 1.1e-6, on near-zero coordinates that atol covers), so
  Adam is held to the sgd tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_cnn import FLConfig as JFLConfig  # noqa: E402
from repro.core import case_label_plan  # noqa: E402
from repro.data import client_batches as jclient_batches  # noqa: E402
from repro.fl.round import make_fl_round as jmake_fl_round  # noqa: E402
from repro.kernels.dispatch import client_histograms as jclient_histograms  # noqa: E402
from repro.models.cnn import cnn_init as jcnn_init  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402

from repro_torch.configs import FLConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.data import client_batches  # noqa: E402
from repro_torch.fl import make_fl_round, run_fl_host  # noqa: E402
from repro_torch.kernels.dispatch import client_histograms  # noqa: E402
from repro_torch.models import cnn_loss  # noqa: E402

C, HW = 10, 12
N, PER_ROUND, SAMPLES = 6, 3, 16


def _cfg(cls, **kw):
    base = dict(num_clients=N, clients_per_round=PER_ROUND, global_epochs=2,
                local_epochs=1, batch_size=8, lr=1e-3)
    base.update(kw)
    return cls(**base)


def _round_data(plan_t, seed):
    """One round's images (NumPy noise around per-class means), labels and
    validity, identical for both stacks."""
    rng = np.random.default_rng(seed)
    means = np.random.default_rng(99).standard_normal((C, HW, HW, 1))
    labels = np.asarray(plan_t, np.int32)
    valid = labels >= 0
    images = (means[np.maximum(labels, 0)]
              + 0.35 * rng.standard_normal(labels.shape + (HW, HW, 1)))
    images = (images * valid[..., None, None, None]).astype(np.float32)
    return images, labels, valid


def _jloss(p, b):
    return jcnn_loss(p, b["images"], b["labels"], b["valid"])


def _tloss(p, b):
    return cnn_loss(p, b["images"], b["labels"], b["valid"])


def _run_both(case, optimizer, aggregation, strategy="labelwise"):
    plan = case_label_plan(case, 5, 2, N, num_classes=C,
                           samples_per_client=SAMPLES, majority=12)
    init = jcnn_init(jax.random.PRNGKey(1), num_classes=C, image_size=HW,
                     c1=4, c2=6, hidden=16)
    jround = jmake_fl_round(_jloss, _cfg(JFLConfig, optimizer=optimizer),
                            strategy, aggregation)
    tround = make_fl_round(_tloss, _cfg(FLConfig, optimizer=optimizer),
                           strategy, aggregation)
    jp, tp = init, params_from_jax(init, device="cpu")
    rounds = []
    for t in range(2):
        images, labels, valid = _round_data(plan[t], seed=t)
        data = {"images": images, "labels": labels, "valid": valid}
        jdata = {k: jnp.asarray(v) for k, v in data.items()}
        tdata = {k: torch.from_numpy(v) for k, v in data.items()}
        jh = jclient_histograms(jnp.where(jdata["valid"], jdata["labels"], 0),
                                C, jdata["valid"])
        th = client_histograms(torch.where(tdata["valid"], tdata["labels"], 0),
                               C, tdata["valid"])
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        jb, tb = jclient_batches(jdata, 8), client_batches(tdata, 8)
        for k in tb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        jp_prev, tp_prev = jp, tp
        jp, jinfo = jround(jp, jb, jh, jax.random.PRNGKey(t))
        tp, tinfo = tround(tp, tb, th)
        rounds.append((jp_prev, tp_prev, jp, tp, jinfo, tinfo))
    return rounds


def _assert_selection_equal(jinfo, tinfo):
    for k in ("selected", "live", "mask", "num_selected", "mask_sum"):
        np.testing.assert_array_equal(np.asarray(tinfo[k]),
                                      np.asarray(jinfo[k]), err_msg=k)
    assert tinfo["budget"] == int(jinfo["budget"])


def _assert_params_close(tp, jp, atol):
    back = params_to_jax(tp)
    for layer in jp:
        for name in jp[layer]:
            np.testing.assert_allclose(back[layer][name],
                                       np.asarray(jp[layer][name]),
                                       rtol=1e-5, atol=atol,
                                       err_msg=f"{layer}.{name}")


@pytest.mark.parametrize("optimizer,aggregation", [
    ("sgd", "fedavg"), ("sgd", "fedsgd"), ("adam", "fedavg")])
def test_two_rounds_match_reference(optimizer, aggregation):
    for jp_prev, _, jp, tp, jinfo, tinfo in _run_both(
            "iid", optimizer, aggregation):
        _assert_selection_equal(jinfo, tinfo)
        assert float(tinfo["num_selected"]) == PER_ROUND
        _assert_params_close(tp, jp, 1e-6)
        moved = max(float(np.abs(np.asarray(jp[l][n])
                                 - np.asarray(jp_prev[l][n])).max())
                    for l in jp for n in jp[l])
        assert moved > 1e-4  # the round really trained
        np.testing.assert_allclose(float(tinfo["client_loss"]),
                                   float(jinfo["client_loss"]), rtol=1e-5)


@pytest.mark.parametrize("aggregation", ["fedavg", "fedsgd"])
def test_empty_selection_leaves_params_unchanged(aggregation):
    """case1a gives every client one label (σ² = 0), so labelwise selects
    nobody; both stacks keep the params bit for bit."""
    for jp_prev, tp_prev, jp, tp, jinfo, tinfo in _run_both(
            "case1a", "sgd", aggregation):
        _assert_selection_equal(jinfo, tinfo)
        assert float(tinfo["num_selected"]) == 0
        for k in tp:
            assert torch.equal(tp[k], tp_prev[k])
        _assert_params_close(tp, jp, 0)


def test_run_fl_host_end_to_end_on_cpu():
    cfg = _cfg(FLConfig, optimizer="adam", global_epochs=3)
    plan = case_label_plan("case1b", 2, 3, N, samples_per_client=SAMPLES,
                           majority=12)
    for strategy in ("labelwise", "random", "full"):
        hist = run_fl_host(plan, cfg, strategy=strategy, eval_n_per_class=2,
                           device="cpu")
        assert len(hist.accuracy) == len(hist.loss) == 3
        assert np.all(np.isfinite(hist.accuracy))
        assert np.all(np.isfinite(hist.loss))
        budget = N if strategy == "full" else PER_ROUND
        assert all(0 < s <= budget for s in hist.num_selected)
        assert hist.wall_s > 0
    runs = [run_fl_host(plan, cfg, strategy="random", eval_n_per_class=2,
                        device="cpu") for _ in range(2)]
    assert runs[0].loss == runs[1].loss  # seeded keys: reproducible
