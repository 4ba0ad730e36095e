"""Parity of the port's CNN, optimizers and parameter converter with the JAX
reference on the CPU.

The same NumPy-made images and labels and the same reference init (carried
over by ``params_from_jax``) go through both stacks.  Loss, accuracy and
gradients agree to rtol 1e-5 / atol 1e-6 (float32 convolutions and matmuls
summed in another order).  The optimizer updates are elementwise and agree
to rtol 1e-6 / atol 1e-9.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad_and_value  # noqa: E402

from repro.models.cnn import cnn_init as jcnn_init  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models import cnn_apply, cnn_init, cnn_loss  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

C, HW, C1, C2, HID = 10, 12, 4, 6, 16


def _init():
    return jcnn_init(jax.random.PRNGKey(3), num_classes=C, image_size=HW,
                     c1=C1, c2=C2, hidden=HID)


def _batch(b=9, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, HW, HW, 1)).astype(np.float32)
    labels = rng.integers(0, C, b).astype(np.int32)
    labels[-1] = -1                     # a padded row
    valid = labels >= 0
    return images, labels, valid


def _close(port, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_param_conversion_round_trip_and_layout():
    ref = _init()
    port = params_from_jax(ref, device="cpu")
    assert port["conv1.w"].shape == (C1, 1, 3, 3)          # OIHW
    assert port["conv2.w"].shape == (C2, C1, 3, 3)
    assert port["fc1.w"].shape == ((HW // 4) ** 2 * C2, HID)  # (in, out)
    back = params_to_jax(port)
    assert set(back) == set(ref)
    for layer in ref:
        for name in ref[layer]:
            np.testing.assert_array_equal(back[layer][name],
                                          np.asarray(ref[layer][name]))


def test_cnn_init_shapes_match_reference():
    port = cnn_init(rng.PRNGKey(0), num_classes=C,
                    image_size=HW, c1=C1, c2=C2, hidden=HID, device="cpu")
    ref = params_from_jax(_init(), device="cpu")
    assert {k: v.shape for k, v in port.items()} == {
        k: v.shape for k, v in ref.items()}
    assert all(torch.count_nonzero(port[k]) == 0 for k in port
               if k.endswith(".b"))


@pytest.mark.parametrize("masked", [False, True])
def test_cnn_loss_and_gradients_match(masked):
    ref_params = _init()
    images, labels, valid = _batch()
    if not masked:
        labels = np.abs(labels)
        valid = None
    jv = None if valid is None else jnp.asarray(valid)
    (jl, jaux), jg = jax.value_and_grad(jcnn_loss, has_aux=True)(
        ref_params, jnp.asarray(images), jnp.asarray(labels), jv)
    port = params_from_jax(ref_params, device="cpu")
    tv = None if valid is None else torch.from_numpy(valid)
    tg, (tl, taux) = grad_and_value(cnn_loss, has_aux=True)(
        port, torch.from_numpy(images), torch.from_numpy(labels), tv)
    _close(tl, jl)
    _close(taux["accuracy"], jaux["accuracy"])
    _close(taux["n"], jaux["n"])
    back = params_to_jax(tg)
    for layer in jg:
        for name in jg[layer]:
            _close(back[layer][name], jg[layer][name])


def test_cnn_apply_flattens_in_reference_order():
    """fc1's rows are (H, W, C)-ordered: logits match the reference's."""
    from repro.models.cnn import cnn_apply as jcnn_apply
    ref_params = _init()
    images, _, _ = _batch(b=4, seed=1)
    ref = jcnn_apply(ref_params, jnp.asarray(images))
    port = cnn_apply(params_from_jax(ref_params, device="cpu"),
                     torch.from_numpy(images))
    assert port.shape == (4, C)
    _close(port, ref)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_updates_match(name):
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(
        -6, 1, v.shape)).astype(np.float32) for k, v in params.items()}
        for _ in range(4)]
    jo = jopt.get_optimizer(name, 1e-3)
    to = topt.get_optimizer(name, 1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jax.jit(jo.update)({k: jnp.asarray(v) for k, v in g.items()},
                                    js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        for k in params:
            _close(tu[k], ju[k], rtol=1e-6, atol=1e-9)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for k in params:
            _close(tp[k], jp[k], rtol=1e-6, atol=1e-9)
    assert ts.step == int(js.step) == len(grads)
    with pytest.raises(KeyError):
        topt.get_optimizer("lion", 1e-3)
