"""The port's mesh train step (data parallelism with FSDP of the weights'
``EMBED`` rows over a ``data`` axis of ranks) against the JAX reference's
``make_train_step(cfg, mesh, ...)`` on the CPU.

* ``model_param_specs`` equals the reference's tree for every arch of
  ``configs/``, with the stacked layer axis unstacked; the placement names
  (``shardings_for``, ``tree_to_specs``, ``is_axes_tuple``, ``shard_ctx``,
  ``constrain``, ``make_debug_mesh``) give the reference's specs.
* Four ``gloo`` ranks in one spawn (``tests/torch_mesh_ranks.py``): shard
  and gather round-trip exactly at G = 4 and 2; a narrow float32 qwen3-14b
  (scanned, rematerialised) and a reduced jamba-v0.1-52b (attention, Mamba
  and a capacity-dropping MoE) take 2 steps at microbatches 1 and 2,
  against the port's no-group step and the reference's step on a
  one-device mesh with ``fsdp=True``.  The tolerances are
  tests/test_torch_train.py's: losses within ``LOSS_RTOL`` = 1e-5
  relative, the parameters within ``STEP_REL`` = 1e-3 of the reference's
  update.  The jamba case keeps exactly the assignments the whole call
  keeps under the reference's rule (``repro/models/layers.py:404-416``),
  which differ from what each rank's tokens alone would keep, and its aux
  loss is the whole call's E·Σ f·p̄ (1e-5 relative, float32 against a
  float64 sum).
* Each rank's drawn rows are bit-equal to the whole draw's rows.
* A one-rank group is bit-equal to no group: the step's losses, norms,
  params and moments, and ``run_train``'s losses and checkpoint file.

The slow tier holds the four ranks against the reference's step on a
four-device CPU mesh (a subprocess, as the device count must be set before
JAX starts).
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import sharding as jsh  # noqa: E402
from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.mesh import make_debug_mesh as jmake_debug_mesh  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models import model_param_specs as jmodel_param_specs  # noqa: E402
from repro.models.transformer import stack_plan as jstack_plan  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch import sharding as sh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.convert import lm_params_to_jax  # noqa: E402
from repro_torch.data import TokenDataset, modality_inputs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.steps import (abstract_params, batch_rows,  # noqa: E402
                                      make_train_step, param_layout)
from repro_torch.launch.train import run_train, synth_lm_batch  # noqa: E402
from repro_torch.models import init_model, model_param_specs  # noqa: E402
from repro_torch.models.transformer import (flatten_params,  # noqa: E402
                                            unflatten_params)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
STEP_REL = 1e-3
AUX_RTOL = 1e-5
WORLD = 4
STEPS, BATCH, SEQ = 2, 8, 16
QWEN = ("qwen3-14b", dict(dtype="float32", d_model=64, vocab_size=128,
                          num_layers=2, scan_layers=True, remat=True))
# capacity_factor 0.5: a call of t tokens keeps ceil8(t/4) assignments an
# expert out of about t/2 routed to it, so every expert drops.
JAMBA = ("jamba-v0.1-52b", dict(dtype="float32", d_model=64, vocab_size=128,
                                moe_dropless=False, capacity_factor=0.5))
CASES = [(arch, over, mb) for arch, over in (QWEN, JAMBA) for mb in (1, 2)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test (the suite runs several test
    processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(cfg):
    """The port's draws of the cases' global batches (bit-equal to the
    reference's, tests/test_torch_train.py)."""
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=SEQ, device="cpu")
    return [synth_lm_batch(ds, rng.fold_in(rng.PRNGKey(0), i), BATCH)
            for i in range(STEPS)]


def _one_device_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _port_steps(cfg, mb, batches, mesh=None):
    """The port's step, with no group or on ``mesh`` (a one-rank group
    here) -> (losses, norms, flat params, state)."""
    step, opt = make_train_step(cfg, InputShape("c", SEQ, BATCH, "train"),
                                mb, mesh=mesh, fsdp=True)
    layout = None if mesh is None else param_layout(cfg, mesh, True)
    params = init_model(rng.PRNGKey(0), cfg, device="cpu", layout=layout)
    state = opt.init(flatten_params(params))
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, flatten_params(params), state


def _ref_leaves(flat, cfg):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        lm_params_to_jax(unflatten_params(flat), cfg))]


def _param_gap(got, want, init):
    """The parameters' distance over the reference's update, both in norm."""
    gap = np.sqrt(sum(((g - w) ** 2).sum() for g, w in zip(got, want)))
    upd = np.sqrt(sum(((w - i) ** 2).sum() for w, i in zip(want, init)))
    return gap / upd


# ---------------------------------------------------------------------------
# Specs and placement names
# ---------------------------------------------------------------------------

def _unstacked(ref_specs, jcfg):
    """The reference's spec tree with its stacked layer axis unstacked and
    tuples of blocks as lists: the port's layout."""
    def lists(node):
        if isinstance(node, dict):
            return {k: lists(v) for k, v in node.items()}
        if isinstance(node, tuple) and not jsh.is_axes_tuple(node):
            return [lists(v) for v in node]
        return node

    out = lists(ref_specs)
    kinds, period, reps = jstack_plan(jcfg)
    if reps > 1 and not jcfg.is_encoder_decoder:
        one = [jax.tree_util.tree_map(lambda ax: tuple(ax)[1:], b,
                                      is_leaf=jsh.is_axes_tuple)
               for b in out["stack"]["blocks"]]
        out["stack"]["blocks"] = [one[j] for _ in range(reps)
                                  for j in range(period)]
    return out


@pytest.mark.parametrize("arch", sorted(jall_configs()))
def test_model_param_specs_match_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    want = _unstacked(jmodel_param_specs(jcfg), jcfg)
    got = model_param_specs(tcfg)
    assert got == want
    shapes = flatten_params(abstract_params(tcfg))
    specs = flatten_params(got)
    assert list(specs) == list(shapes)
    assert all(len(specs[k]) == shapes[k].dim() for k in shapes)


def test_placement_names_match_reference():
    jcfg = jget_config("jamba-v0.1-52b").reduced(d_model=64, vocab_size=128)
    tcfg = get_config("jamba-v0.1-52b").reduced(d_model=64, vocab_size=128)
    jmesh = _one_device_mesh()
    jrules = jsh.make_rules(jmesh, "train", True)
    rules = sh.make_rules({"data": 1, "model": 1}, "train", True)
    jabs = jax.eval_shape(lambda k: jinit_model(k, jcfg)[0],
                          jax.random.PRNGKey(0))
    want = _unstacked(jax.tree_util.tree_map(
        lambda n: tuple(n.spec),
        jsh.shardings_for(jabs, jmodel_param_specs(jcfg), jmesh, jrules)),
        jcfg)
    got = sh.shardings_for(abstract_params(tcfg), model_param_specs(tcfg),
                           {"data": 1, "model": 1}, rules)
    got_specs = jax.tree_util.tree_map(lambda n: n.spec, got,
                                       is_leaf=lambda n: isinstance(
                                           n, sh.NamedSharding))
    assert got_specs == want
    jtree = jsh.tree_to_specs(jmodel_param_specs(jcfg), jrules)
    want = _unstacked(jax.tree_util.tree_map(tuple, jtree,
                                             is_leaf=lambda p: isinstance(
                                                 p, jax.sharding.PartitionSpec)),
                      jcfg)
    assert sh.tree_to_specs(model_param_specs(tcfg), rules) == want
    for x in [(), ("embed", None), (None,), ("a", 1), [("a",)], "a"]:
        assert sh.is_axes_tuple(x) == jsh.is_axes_tuple(x), x
    # Outside a context constrain is the identity, as the reference's.
    x = torch.ones(2, 3)
    assert sh.constrain(x, sh.BATCH, sh.SEQ) is x
    with sh.shard_ctx({"data": 4, "model": 1},
                      sh.make_rules({"data": 4, "model": 1})):
        assert sh.constrain(x, sh.BATCH, sh.SEQ, sh.VOCAB) is x
        assert sh.gather(x) is x and sh.sum_over_ranks(x) is x
    with sh.shard_ctx({"data": 2, "model": 2},
                      sh.make_rules({"data": 2, "model": 2})):
        with pytest.raises(NotImplementedError, match="tensor"):
            sh.constrain(x, sh.BATCH, sh.SEQ, sh.VOCAB)
    seq = {"data": 1, "model": 2}
    with sh.shard_ctx(seq, sh.make_rules(seq, seq_parallel=True)):
        with pytest.raises(NotImplementedError):
            sh.constrain(x, sh.BATCH, sh.RESIDUAL_SEQ, None)


def test_rank_rows_are_the_whole_draws_rows():
    cfg_v = get_config("phi-3-vision-4.2b").reduced(vocab_size=64)
    cfg_a = get_config("whisper-tiny").reduced(vocab_size=64)
    ds = TokenDataset(vocab_size=64, seq_len=12, device="cpu")
    key = rng.fold_in(rng.PRNGKey(0), 3)
    full = synth_lm_batch(ds, key, 8)
    modal = {**modality_inputs(cfg_v, key, 8), **modality_inputs(cfg_a, key, 8)}
    seen = []
    for mb in (1, 2):
        for r in range(WORLD):
            rows = batch_rows(8, mb, r, WORLD)
            seen.append(rows)
            mine = synth_lm_batch(ds, key, 8, rows=rows)
            for k in full:
                assert torch.equal(mine[k], full[k][rows]), k
            got = {**modality_inputs(cfg_v, key, 8, rows=rows),
                   **modality_inputs(cfg_a, key, 8, rows=rows)}
            for k in modal:
                assert torch.equal(got[k], modal[k][rows]), k
    # Each microbatch's rows are spread over the ranks in rank order.
    assert batch_rows(8, 2, 1, 4).tolist() == [1, 5]
    assert sorted(torch.cat(seen[:WORLD]).tolist()) == list(range(8))
    with pytest.raises(ValueError):
        batch_rows(6, 2, 0, 4)


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------

def _start_ranks(out: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
         str(out), str(_cases_file(out)), "--world", str(WORLD)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def _wait(proc, out: Path, timeout=600):
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stderr[-4000:]
    for r in range(WORLD):
        assert (out / f"rank{r}.ok").is_file(), r


def _keep_of(e_by_token, cap):
    """The reference's capacity rule on a call's (token, choice) experts
    (repro/models/layers.py:404-416): assignments sorted stably by expert,
    an expert's first ``cap`` kept -> the kept (token, expert) pairs."""
    flat_e = e_by_token.reshape(-1)
    k = e_by_token.shape[1]
    order = np.argsort(flat_e, kind="stable")
    se = flat_e[order]
    counts = np.bincount(flat_e, minlength=int(flat_e.max()) + 1)
    starts = np.cumsum(counts) - counts
    keep = (np.arange(flat_e.size) - starts[se]) < cap
    return {(int(t) // k, int(e)) for t, e, kp in zip(order, se, keep) if kp}


def _capacity(cfg, tokens):
    cap = int(np.ceil(cfg.experts_per_token * tokens * cfg.capacity_factor
                      / cfg.num_experts))
    return max(8, -(-cap // 8) * 8)


def _check_moe(out: Path, i: int, cfg):
    """The ranks' kept assignments and aux losses against the whole call's,
    call by call (rank r's tokens follow rank r−1's)."""
    k = cfg.experts_per_token
    ranks = [np.load(out / f"case{i}_rank{r}.npz") for r in range(WORLD)]
    calls = sum(1 for n in ranks[0].files if n.startswith("keep"))
    assert calls > 0
    dropped = 0
    for c in range(calls):
        kept, experts, own = set(), [], set()
        offset = 0
        for z in ranks:
            flat_e, order, keep = z[f"flat_e{c}"], z[f"order{c}"], z[f"keep{c}"]
            t = flat_e.size // k
            for pos, (o, kp) in enumerate(zip(order, keep)):
                if kp:
                    kept.add((offset + int(o) // k, int(flat_e[o])))
            by_token = flat_e.reshape(t, k)
            experts.append(by_token)
            own |= {(offset + tok, e) for tok, e in
                    _keep_of(by_token, _capacity(cfg, t))}
            offset += t
        every = np.concatenate(experts)
        want = _keep_of(every, _capacity(cfg, offset))
        assert kept == want, c
        assert own != want, c          # each rank alone would drop others
        dropped += every.size - len(want)
        # aux: E·Σ_e f_e·p̄_e over the whole call's tokens, in float64.
        x = np.concatenate([z[f"x{c}"] for z in ranks]).astype(np.float64)
        logits = x @ ranks[0][f"router{c}"].astype(np.float64)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        e = cfg.num_experts
        top1 = np.bincount(np.argmax(probs, -1), minlength=e) / len(x)
        aux = e * np.sum(top1 * probs.mean(0))
        for z in ranks:
            assert abs(float(z[f"aux{c}"]) - aux) <= AUX_RTOL * aux, (
                c, float(z[f"aux{c}"]), aux)
    assert dropped > 0


def _cases_file(out: Path) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    path = out / "cases.json"
    path.write_text(json.dumps(
        [{"arch": a, "over": o, "mb": mb, "steps": STEPS, "batch": BATCH,
          "seq": SEQ} for a, o, mb in CASES]))
    return path


def _start_refs(out: Path, which, devices: int = 1) -> subprocess.Popen:
    """The reference's steps for ``CASES[i]``, i in ``which``, on a
    (``devices``, 1) mesh of host devices, in a subprocess
    (tests/torch_mesh_reference.py) -> OUT/ref<i>.npz."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_reference.py"),
         str(out), str(_cases_file(out)), "--devices", str(devices),
         "--which", ",".join(str(i) for i in which)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait_ref(proc, timeout=900):
    _, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stderr[-4000:]


def _ranked_vs_refs(port: Path, refs: Path, alone=None):
    """Each case's four-rank run against the reference's (and the port's
    no-group run, where given)."""
    for i, (arch, over, mb) in enumerate(CASES):
        tcfg = get_config(arch).reduced(**over)
        init = _ref_leaves(flatten_params(init_model(
            rng.PRNGKey(0), tcfg, device="cpu")), tcfg)
        r = np.load(refs / f"ref{i}.npz")
        jparams = [r[f"p{j}"] for j in range(len(r.files) - 1)]
        z = np.load(port / f"case{i}.npz")
        ranked = _ref_leaves({k[2:]: torch.from_numpy(z[k])
                              for k in z.files if k.startswith("p:")}, tcfg)
        what = f"{arch} microbatches {mb}"
        np.testing.assert_allclose(z["losses"], r["losses"], rtol=LOSS_RTOL,
                                   err_msg=what)
        to_ref = _param_gap(ranked, jparams, init)
        print(f"{what}: 4 ranks' params {to_ref:.2e} of the update from "
              f"the reference's")
        assert to_ref <= STEP_REL, what
        if alone is not None:
            losses, flat = alone[i]
            np.testing.assert_allclose(z["losses"], losses, rtol=LOSS_RTOL,
                                       err_msg=what)
            to_alone = _param_gap(ranked, _ref_leaves(flat, tcfg), init)
            print(f"{what}: {to_alone:.2e} from no group's")
            assert to_alone <= STEP_REL, what
            if arch == JAMBA[0]:
                _check_moe(port, i, tcfg)


def test_four_gloo_ranks_match_no_group_and_reference(tmp_path):
    # The ranks and one reference process a case run at once.
    procs = [_start_ranks(tmp_path)] + [
        _start_refs(tmp_path, [i]) for i in range(len(CASES))]
    try:
        alone = {}
        for i, (arch, over, mb) in enumerate(CASES):
            cfg = get_config(arch).reduced(**over)
            losses, _, flat, _ = _port_steps(cfg, mb, _batches(cfg))
            alone[i] = (losses, flat)
    finally:
        _wait(procs[0], tmp_path)
        for p in procs[1:]:
            _wait_ref(p)
    _ranked_vs_refs(tmp_path, tmp_path, alone)


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _one_rank(store: Path):
    """A one-rank gloo group and its debug mesh, for the block's duration."""
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        yield make_debug_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_group_is_bit_equal_to_no_group(tmp_path):
    runs = [(arch, over, mb, _batches(get_config(arch).reduced(**over)))
            for arch, over, mb in CASES]
    alone = [_port_steps(get_config(a).reduced(**o), mb, b)
             for a, o, mb, b in runs]
    alone_losses = run_train("qwen3-14b", 2, 2, 16, True, device="cpu",
                             ckpt_dir=str(tmp_path / "alone"))
    with _one_rank(tmp_path / "store") as mesh:
        assert sh.mesh_axes(mesh) == dict(jmake_debug_mesh().shape)
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(NotImplementedError):
            make_debug_mesh(model=2)
        for (arch, over, mb, batches), a in zip(runs, alone):
            b = _port_steps(get_config(arch).reduced(**over), mb, batches,
                            mesh)
            assert a[:2] == b[:2], (arch, mb)
            assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
            for m in ("mu", "nu"):
                assert all(torch.equal(getattr(a[3], m)[k],
                                       getattr(b[3], m)[k]) for k in a[2])
        # run_train on the mesh: the same losses and checkpoint file.
        grouped = run_train("qwen3-14b", 2, 2, 16, True, device="cpu",
                            ckpt_dir=str(tmp_path / "mesh"))
        with pytest.raises(RuntimeError, match="gloo"):
            run_train("qwen3-14b", 1, 1, 8, True, device="cuda")
    assert grouped == alone_losses
    for ext in ("npz", "json"):
        name = f"ckpt_00000002.{ext}"
        assert (tmp_path / "mesh" / name).read_bytes() == \
            (tmp_path / "alone" / name).read_bytes(), ext


# ---------------------------------------------------------------------------
# Slow tier: the reference on four host devices
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_four_ranks_match_reference_on_four_devices(tmp_path):
    """The same cases, the reference's step on a (4, 1) mesh of forced host
    devices with ``fsdp=True`` (its weights' EMBED rows split four ways)."""
    (tmp_path / "port").mkdir()
    procs = [_start_ranks(tmp_path / "port"),
             _start_refs(tmp_path, range(len(CASES)), devices=4)]
    _wait(procs[0], tmp_path / "port")
    _wait_ref(procs[1])
    _ranked_vs_refs(tmp_path / "port", tmp_path)
