"""The port's checkpoints (``repro_torch.ckpt``) against the reference's file
format (``repro/ckpt/checkpoint.py``) on the CPU.

Every comparison is bit for bit: a checkpoint stores leaves, it computes
nothing.  The port round-trips its nested LM params in float32 and bfloat16;
a file the reference saves loads in the port, and a file the port saves
loads in the reference, for the paper CNN and for a reduced LM with stacked
layers (``scan_layers``).  The two stacks' trees differ in layout (the
CNN's conv kernels HWIO against OIHW, its keys nested against dotted; the LM
stack's leading layer axis against a per-layer list), so both files cross
through ``repro_torch.convert``.  ``run_train(..., ckpt_dir=...)`` writes
the reference's sidecar ``extra``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import load_checkpoint as jload_checkpoint  # noqa: E402
from repro.ckpt import save_checkpoint as jsave_checkpoint  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import cnn_init as jcnn_init  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402

from repro_torch.ckpt import (latest_checkpoint, load_checkpoint,  # noqa: E402
                              read_checkpoint, save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (lm_params_from_jax,  # noqa: E402
                                 lm_params_to_jax, params_from_jax,
                                 params_to_jax)
from repro_torch.launch.steps import abstract_params  # noqa: E402
from repro_torch.launch.train import run_train  # noqa: E402
from repro_torch.models import cnn_init  # noqa: E402
from repro_torch.models.transformer import flatten_params  # noqa: E402
from repro_torch.rng import PRNGKey  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: the tensors are small, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    """An array's raw bits (bf16 as its 16-bit words)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_tree(got, want):
    got, want = flatten_params(got), flatten_params(want)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)


def _random(template, seed):
    """A tree of ``template``'s shapes and dtypes filled from a seed."""
    g = torch.Generator().manual_seed(seed)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return torch.randn(t.shape, generator=g).to(t.dtype)

    return fill(template)


def _jax_tree(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


def _cfgs(arch, **over):
    """The reduced config with stacked layers (a leading layer axis in the
    reference's params), on both sides."""
    over = {"scan_layers": True, **over}
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b"])
def test_port_round_trip_is_bit_equal(tmp_path, arch, dtype):
    _, cfg = _cfgs(arch, dtype=dtype)
    params = _random(abstract_params(cfg), 3)
    path = save_checkpoint(str(tmp_path), 5, params, {"arch": arch})
    assert os.path.basename(path) == "ckpt_00000005.npz"
    got, meta = load_checkpoint(path, abstract_params(cfg), device="cpu")
    assert meta == {"step": 5, "extra": {"arch": arch}}
    assert isinstance(got["stack"]["blocks"], list)
    _same_tree(got, params)


def test_load_raises_on_a_mismatch_or_a_missing_leaf(tmp_path):
    _, cfg = _cfgs("qwen3-14b")
    path = save_checkpoint(str(tmp_path), 1,
                           _random(abstract_params(cfg), 0))
    with pytest.raises(ValueError, match="template"):     # bf16 file
        load_checkpoint(path, abstract_params(
            dataclasses.replace(cfg, dtype="float32")), device="cpu")
    with pytest.raises(ValueError, match="template"):     # another vocab
        load_checkpoint(path, abstract_params(
            dataclasses.replace(cfg, vocab_size=256)), device="cpu")
    with pytest.raises(KeyError, match="blocks/2"):       # one layer more
        load_checkpoint(path, abstract_params(
            dataclasses.replace(cfg, num_layers=3)), device="cpu")
    tmpl = abstract_params(cfg)
    tmpl["extra_leaf"] = torch.empty(2, device="meta")
    with pytest.raises(KeyError, match="extra_leaf"):
        load_checkpoint(path, tmpl, device="cpu")


def test_latest_checkpoint_picks_the_highest_step(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    tree = {"w": torch.arange(4.0)}
    for step in (3, 12, 7):
        save_checkpoint(str(tmp_path), step, tree)
    assert latest_checkpoint(str(tmp_path)) == str(
        tmp_path / "ckpt_00000012.npz")


def test_cnn_files_cross_both_ways(tmp_path):
    # The reference's own tree (its structure, dtypes and HWIO layout),
    # leaves made from the port's draw.
    jparams = _jax_tree(params_to_jax(cnn_init(PRNGKey(1), device="cpu")))
    assert (jax.tree_util.tree_structure(jparams)
            == jax.tree_util.tree_structure(
                jax.eval_shape(jcnn_init, jax.random.PRNGKey(1))))
    # Reference -> port, through the CNN converter.
    jpath = jsave_checkpoint(str(tmp_path / "ref"), 2, jparams, {"r": 1})
    tree, meta = read_checkpoint(jpath)
    assert meta == {"step": 2, "extra": {"r": 1}}
    _same_tree(params_from_jax(tree, device="cpu"),
               params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu"))
    # Port -> reference.
    port = cnn_init(PRNGKey(4), device="cpu")
    ppath = save_checkpoint(str(tmp_path / "port"), 3, params_to_jax(port))
    back, meta = jload_checkpoint(ppath, jparams)
    assert meta["step"] == 3
    want = params_to_jax(port)
    for name in want:
        for leaf in want[name]:
            np.testing.assert_array_equal(np.asarray(back[name][leaf]),
                                          want[name][leaf])
    # The keys do not agree without the converter: the port's flat tree is
    # keyed "conv1.w", the reference's nested one "conv1/w".
    native = save_checkpoint(str(tmp_path / "native"), 0, port)
    assert set(np.load(native).files) != set(np.load(jpath).files)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_files_cross_both_ways(tmp_path, dtype):
    jcfg, cfg = _cfgs("qwen3-14b", dtype=dtype)
    # The reference's own tree (blocks stacked on a leading layer axis),
    # leaves from a seed.
    jparams = _jax_tree(lm_params_to_jax(_random(abstract_params(cfg), 2),
                                         cfg))
    abstract = jax.eval_shape(lambda k: jinit_model(k, jcfg)[0],
                              jax.random.PRNGKey(2))
    assert jax.tree_util.tree_structure(jparams) == \
        jax.tree_util.tree_structure(abstract)
    assert jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), jparams) == \
        jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), abstract)
    assert jparams["stack"]["blocks"][0]["attn"]["wq"].shape[0] == 2
    # Reference -> port: the file's stacked blocks become the layer list.
    jpath = jsave_checkpoint(str(tmp_path / "ref"), 4, jparams,
                             {"arch": "qwen3-14b"})
    tree, _ = read_checkpoint(jpath)
    got = lm_params_from_jax(tree, cfg, device="cpu")
    want = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu")
    _same_tree(got, want)
    assert got["embed"]["table"].dtype == getattr(torch, dtype)
    # Port -> reference: the layer list restacked, loaded by the reference.
    port = _random(abstract_params(cfg), 5)
    ppath = save_checkpoint(str(tmp_path / "port"), 6,
                            lm_params_to_jax(port, cfg))
    back, meta = jload_checkpoint(ppath, jparams)
    assert meta == {"step": 6, "extra": {}}
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        lm_params_to_jax(port, cfg)))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        assert leaf.dtype == jnp.dtype(dtype)
        np.testing.assert_array_equal(_bits(np.asarray(leaf)),
                                      _bits(flat_want[path]))


def test_run_train_writes_a_checkpoint(tmp_path):
    losses = run_train("qwen3-14b", steps=2, batch=2, seq=16, reduced=True,
                       ckpt_dir=str(tmp_path), log_every=10, device="cpu")
    path = latest_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "ckpt_00000002.npz")
    with open(path.replace(".npz", ".json")) as f:
        meta = json.load(f)
    assert meta == {"step": 2, "extra": {"arch": "qwen3-14b",
                                         "loss": losses[-1]}}
    cfg = get_config("qwen3-14b").reduced(vocab_size=512)
    params, _ = load_checkpoint(path, abstract_params(cfg), device="cpu")
    assert all(torch.isfinite(p.float()).all()
               for p in flatten_params(params).values())
