"""The port's launch tooling against the JAX reference on the CPU: the
sharding rule tables, the input specs, the step builders' static facts, the
prefill and serve steps, and the roofline's counts and the dry-run CLI.

Nothing of the reference is lowered or compiled here (its step lowering is
its own slow tier, tests/test_launch_steps.py): its rules and specs are pure
functions (``jax.sharding.AbstractMesh`` stands for the production meshes),
its steps are called unjitted.  Tolerances:

* rule tables, specs, shapes, dtypes, logical axes and the static counts:
  equal;
* the prefill and serve steps at ``reduced(dtype="float32")``: tokens
  bit-equal; the caches within ``TOL`` = 2e-4 of tests/test_torch_lm.py
  (float32 sums in other orders, the chunked SSD against the recurrence);
* the kernel ops' FLOP formulas at PERF.md's kernel-table shapes: the
  integer operation counts behind its bounds (43.0, 107.5 and 13.0 GFLOP);
* a reduced qwen3-14b prefill's traced FLOPs: exactly the count written out
  from its config; a reduced train step's: 3× its forward's within 5% (the
  backward of a product is two products, attention's backward 2.5×).
"""
import dataclasses
import functools
import itertools
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro import sharding as jsh  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.shapes import InputShape as JInputShape  # noqa: E402
from repro.data import specs as jspecs  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402

from repro_torch import sharding as sh  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402,E501
from repro_torch.data import specs  # noqa: E402
from repro_torch.launch import dryrun, mesh, roofline, steps  # noqa: E402
from repro_torch.models import ModelConfig, init_model, loss_fn  # noqa: E402
from repro_torch.rng import PRNGKey  # noqa: E402
from repro_torch.models.transformer import (flatten_params,  # noqa: E402
                                            stack_plan, unflatten_params)

TOL = 2e-4
ARCHS = ("qwen3-14b", "mamba2-1.3b")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def dryrun_cli(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --arch mamba2-1.3b --shape
    long_500k --no-save`` on this host (no card, no nvcc), started when
    the module's first test starts, so that it runs beside the others; its
    test reads it last."""
    home = tmp_path_factory.mktemp("dryrun_cli")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-1.3b", "--shape", "long_500k", "--no-save"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(home), "TMPDIR": str(home), "OMP_NUM_THREADS": "1"})
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch a test: the tensors are small, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
LOGICAL = (jsh.BATCH, jsh.SEQ, jsh.KV_SEQ, jsh.EMBED, jsh.VOCAB, jsh.HEADS,
           jsh.KV_HEADS, jsh.HEAD_DIM, jsh.FF, jsh.EXPERTS, jsh.MOE_FF,
           jsh.SSM_INNER, jsh.SSM_STATE, jsh.RESIDUAL_SEQ, jsh.CLIENTS, None)


def _entries(spec):
    """A spec's entries as a ``PartitionSpec`` reads them: a one-name tuple
    is that name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("which", list(MESHES))
def test_rules_and_specs_equal_the_reference(which, mode):
    sizes, names = MESHES[which]
    jmesh = AbstractMesh(sizes, names)
    tmesh = dict(zip(names, sizes))
    assert tmesh == mesh.production_mesh(multi_pod=which == "multi_pod")
    for fsdp, kv, tp, sp in itertools.product(
            (True, False), ("seq", "heads"), (True, False), (True, False)):
        jr = jsh.make_rules(jmesh, mode, fsdp, kv_policy=kv, tp=tp,
                            seq_parallel=sp)
        tr = sh.make_rules(tmesh, mode, fsdp, kv_policy=kv, tp=tp,
                           seq_parallel=sp)
        assert tr == jr
        for a, b in itertools.product(LOGICAL, repeat=2):
            assert _entries(sh.logical_to_spec((a, b), tr)) == _entries(
                jsh.logical_to_spec((a, b), jr))
            for dims in ((512, 32), (7, 8), (16, 1), (1, 256)):
                assert _entries(sh.spec_for_shape(dims, (a, b), tmesh, tr)) \
                    == _entries(jsh.spec_for_shape(dims, (a, b), jmesh, jr)), \
                    (a, b, dims)


def test_reference_rule_cases_hold_on_the_port():
    """tests/test_data_and_sharding.py's own cases, on a 1×1 and a 1×1×1
    mesh given as axis sizes."""
    one = {"data": 1, "model": 1}
    rules = sh.make_rules(one, "train")
    assert sh.spec_for_shape((8, 7), (sh.BATCH, sh.HEADS), one, rules) == (
        ("data",), "model")
    rules = sh.make_rules(one, "decode")
    assert rules[sh.KV_HEADS] is None and rules[sh.KV_SEQ] == "model"
    rules = sh.make_rules({"pod": 1, "data": 1, "model": 1}, "train")
    assert rules[sh.BATCH] == ("pod", "data") and rules[sh.CLIENTS] == "pod"
    with pytest.raises(TypeError):
        sh.make_rules(("data", "model"))
    # A DeviceMesh gives its axes as mesh_dim_names and shape.
    device_mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                        shape=(16, 16))
    assert sh.mesh_axes(device_mesh) == {"data": 16, "model": 16}
    assert sh.make_rules(device_mesh, "decode") == sh.make_rules(
        {"data": 16, "model": 16}, "decode")


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

def _spec_eq(port, ref):
    assert tuple(port.shape) == tuple(ref.shape)
    assert str(port.dtype).replace("torch.", "") == str(ref.dtype)
    assert port.device.type == "meta"


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape_name):
    jshape, tshape = JInputShape(*dataclasses.astuple(SHAPES[shape_name])), \
        SHAPES[shape_name]
    jcfg = jsteps.config_for_shape(jget_config(arch), jshape)
    tcfg = steps.config_for_shape(get_config(arch), tshape)
    jspec, jlog = jspecs.input_specs(jcfg, jshape)
    tspec, tlog = specs.input_specs(tcfg, tshape)
    assert set(tspec) == set(jspec) and set(tlog) == set(jlog)
    if tshape.kind != "decode":
        for k in jspec:
            _spec_eq(tspec[k], jspec[k])
            assert tlog[k] == jlog[k]
        return
    _spec_eq(tspec["tokens"], jspec["tokens"])
    assert tlog["tokens"] == jlog["tokens"]
    # Caches through the converter's layer mapping: port layer r·period + j
    # is repeat r of the reference's block j (leading repeat axis, logical
    # None, when it stacks repeats).
    _, period, reps = stack_plan(tcfg)
    assert len(tspec["caches"]) == len(tlog["caches"]) == period * reps
    for layer, (tc, tl) in enumerate(zip(tspec["caches"], tlog["caches"])):
        jc, jl = jspec["caches"][layer % period], jlog["caches"][layer % period]
        assert set(tc) == set(jc) and tl.keys() == jl.keys()
        for k in jc:
            lead = 1 if reps > 1 else 0
            if k == "idx":
                assert tc[k] == tshape.seq_len - 1 and tl[k] == ()
                assert jc[k].shape[lead:] == () and jc[k].dtype == jnp.int32
                assert jl[k][lead:] == ()
                continue
            assert tuple(tc[k].shape) == tuple(jc[k].shape[lead:])
            assert str(tc[k].dtype).replace("torch.", "") == str(jc[k].dtype)
            assert tl[k] == tuple(jl[k][lead:])
    if arch == "qwen3-14b" and shape_name == "long_500k":
        assert tspec["caches"][0]["k"].shape[1] == 4096      # the window


@pytest.mark.parametrize("arch,extra,slice_name", [
    ("phi-3-vision-4.2b", "patch_embeds", "VLM slice"),
    ("whisper-tiny", "frames", "audio slice")])
def test_modality_batch_specs_equal_the_reference(arch, extra, slice_name):
    """The VLM and encoder-decoder branches on a port ``ModelConfig`` made
    from the reference config's fields, and their decode specs: the VLM's
    as a decoder-only arch's, whisper's ``{"self", "cross"}`` caches."""
    jcfg = jget_config(arch)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    for name in ("train_4k", "prefill_32k"):
        jshape = JInputShape(*dataclasses.astuple(SHAPES[name]))
        jspec, jlog = jspecs.batch_specs(jcfg, jshape)
        tspec, tlog = specs.batch_specs(tcfg, SHAPES[name])
        assert set(tspec) == set(jspec) == ({"tokens", extra} | (
            {"targets"} if name == "train_4k" else set()))
        for k in jspec:
            _spec_eq(tspec[k], jspec[k])
            assert tlog[k] == jlog[k]
        assert specs.text_len(tcfg, 4096) == jspecs.text_len(jcfg, 4096)
    tspec, tlog = specs.decode_specs(tcfg, SHAPES["decode_32k"])
    jshape = JInputShape(*dataclasses.astuple(SHAPES["decode_32k"]))
    jspec, jlog = jspecs.decode_specs(jcfg, jshape)
    if tcfg.is_encoder_decoder:
        assert set(tspec["caches"]) == set(tlog["caches"]) == {"self",
                                                                "cross"}
        assert [c["idx"] for c in tspec["caches"]["self"]] == [
            SHAPES["decode_32k"].seq_len - 1] * tcfg.num_layers
        cross_t, cross_j = tspec["caches"]["cross"], jspec["caches"]["cross"]
        assert len(cross_t) == len(cross_j) == tcfg.num_layers
        for tc, jc, tl, jl in zip(cross_t, cross_j, tlog["caches"]["cross"],
                                  jlog["caches"]["cross"]):
            for k in ("k", "v"):
                _spec_eq(tc[k], jc[k])
                assert tl[k] == jl[k]
    else:
        assert len(tspec["caches"]) == tcfg.num_layers


# ---------------------------------------------------------------------------
# Step builders' static facts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_shape_rules_equal_the_reference(arch, monkeypatch):
    # The reference's param_count traces its init at each call; its value
    # for one config is kept for the calls of this test.
    monkeypatch.setattr(jsteps, "param_count",
                        functools.lru_cache(maxsize=None)(jsteps.param_count))
    jcfg, tcfg = jget_config(arch), get_config(arch)
    assert steps.param_count(tcfg) == jsteps.param_count(jcfg)
    assert roofline.active_param_count(tcfg) == \
        jroofline.active_param_count(jcfg)
    for name, tshape in SHAPES.items():
        jshape = JInputShape(*dataclasses.astuple(tshape))
        assert roofline.model_flops_estimate(tcfg, tshape) == \
            jroofline.model_flops_estimate(jcfg, jshape)
        assert steps.arch_shape_applicable(tcfg, tshape) == \
            jsteps.arch_shape_applicable(jcfg, jshape)
        assert dataclasses.asdict(steps.config_for_shape(tcfg, tshape)) == \
            dataclasses.asdict(jsteps.config_for_shape(jcfg, jshape))


# ---------------------------------------------------------------------------
# Prefill and serve steps
# ---------------------------------------------------------------------------

MESH1 = jax.make_mesh((1, 1), ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def _close_caches(port, ref):
    assert len(port) == len(ref)
    for pc, rc in zip(port, ref):
        assert set(pc) == set(rc)
        for k in pc:
            if k == "idx":
                assert pc[k] == int(rc[k])
            else:
                _close(pc[k], rc[k])


def _np_tree(tree, seed):
    """Every leaf redrawn around its init, as tests/test_torch_lm.py does."""
    g = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a, np.float32)
        std = float(a.std()) or 0.1
        return (a + 0.3 * std * g.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(redraw, tree)


@functools.lru_cache(maxsize=None)
def _weights(arch, seed):
    """The reduced float32 reference tree of ``arch``, every leaf redrawn
    from ``seed`` (shared by the tests: a sliding window changes no
    weight)."""
    cfg = get_config(arch).reduced(dtype="float32")
    return _np_tree(lm_params_to_jax(init_model(PRNGKey(seed), cfg,
                                                device="cpu"), cfg), seed)


def _serve_pair(arch, prompt, gen, batch=2, seed=0, **over):
    """(tokens, caches) of the prefill step and ``gen`` serve steps, port
    and reference, on the same weights and prompt.  The weights: the
    reference's tree (tests/test_torch_lm.py holds the port's init to the
    reference's), every leaf redrawn from a seed."""
    over = {"dtype": "float32", **over}
    jcfg, tcfg = (jget_config(arch).reduced(**over),
                  get_config(arch).reduced(**over))
    tree = _weights(arch, seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = lm_params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, tcfg.vocab_size, (batch, prompt)).astype(np.int32)
    pshape = InputShape("tiny_prefill", prompt + gen, batch, "prefill")
    dshape = InputShape("tiny_decode", prompt + gen, batch, "decode")
    jpshape, jdshape = (JInputShape(*dataclasses.astuple(s))
                        for s in (pshape, dshape))
    out = {}
    tpre, targs = steps.make_prefill_step(tcfg, pshape)
    tserve, sargs = steps.make_serve_step(tcfg, dshape)
    assert targs[1]["tokens"].shape == (batch, prompt + gen)
    assert sargs[1].shape == (batch,)
    jpre = jsteps.make_prefill_step(jcfg, MESH1, jpshape)[0]
    jserve = jsteps.make_serve_step(jcfg, MESH1, jdshape)[0]
    def snapshot(caches):        # the port updates its caches in place
        return [{k: v.clone() if torch.is_tensor(v) else v
                 for k, v in c.items()} for c in caches]

    t_tok, t_caches = tpre(tparams, {"tokens": torch.from_numpy(toks)})
    j_tok, j_caches = jpre(jparams, {"tokens": jnp.asarray(toks)})
    out["prefill"] = (t_tok, j_tok, snapshot(t_caches), j_caches)
    for i in range(gen):
        t_tok, t_caches = tserve(tparams, t_tok, t_caches)
        j_tok, j_caches = jserve(jparams, j_tok, j_caches)
        out[f"serve{i}"] = (t_tok, j_tok, snapshot(t_caches), j_caches)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_the_reference(arch):
    for name, (t_tok, j_tok, t_caches, j_caches) in _serve_pair(
            arch, prompt=19, gen=3).items():
        assert t_tok.dtype == torch.int32, name
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok), name)
        _close_caches(t_caches, j_caches)


def test_windowed_serve_step_matches_the_reference():
    """A sliding window shorter than the prompt: a ring cache of the window,
    the oldest token evicted each step."""
    pair = _serve_pair("qwen3-14b", prompt=19, gen=3, sliding_window=8)
    for name, (t_tok, j_tok, t_caches, j_caches) in pair.items():
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok), name)
        assert t_caches[0]["k"].shape[1] == 8
        _close_caches(t_caches, j_caches)


# ---------------------------------------------------------------------------
# Roofline and dry-run
# ---------------------------------------------------------------------------

def test_collective_bytes_match_the_reference_parser():
    """tests/test_data_and_sharding.py's HLO collectives, as the
    ``_c10d_functional`` ops of an fx graph."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    c10d = torch.ops._c10d_functional
    fake = FakeTensorMode()
    graph = torch.fx.Graph()

    def node(op, args, shape, dtype):
        n = graph.call_function(op, args)
        with fake:
            n.meta["val"] = torch.empty(shape, dtype=dtype)
        return n

    x = graph.placeholder("x")
    with fake:
        x.meta["val"] = torch.empty((1, 512), dtype=torch.bfloat16)
    outs = [
        node(c10d.all_gather_into_tensor.default, (x, 16, "g"), (16, 512),
             torch.bfloat16),
        node(c10d.all_reduce.default, (x, "sum", "g"), (1024,),
             torch.float32),
        node(c10d.reduce_scatter_tensor.default, (x, "sum", 16, "g"), (64,),
             torch.float32),
        node(c10d.all_to_all_single.default, (x, [8], [8], "g"), (8, 32),
             torch.float32),
        node(c10d.all_to_all_single.default, (x, [8], [8], "g"), (8, 32),
             torch.float32),
        node(c10d.irecv.default, (x, 1, 0, "g"), (128,), torch.uint16),
        node(c10d.wait_tensor.default, (x,), (1, 512), torch.bfloat16),
    ]
    graph.output(outs)
    gm = torch.fx.GraphModule(torch.nn.Module(), graph)
    hlo = """
  %ag = bf16[16,512]{1,0} all-gather(bf16[1,512]{1,0} %x), dimensions={0}
  %ar.1 = f32[1024]{0} all-reduce(f32[1024]{0} %y), to_apply=%add
  %rs = f32[64]{0} reduce-scatter(f32[1024]{0} %z), dimensions={0}
  %a2a = (f32[8,32]{1,0}, f32[8,32]{1,0}) all-to-all(f32[8,32]{1,0} %u, f32[8,32]{1,0} %v)
  %cp = u16[128]{0} collective-permute(u16[128]{0} %w), source_target_pairs={{0,1}}
"""
    assert roofline.collective_bytes(gm) == jroofline.collective_bytes(hlo)
    assert tuple(roofline.COLLECTIVES) == tuple(jroofline.collective_bytes(
        ""))


def test_kernel_flop_formulas_give_the_bounds_operation_counts():
    """PERF.md's kernel table: flash_attention at qwen3-14b's prefill (4,
    1024, 40/8, 128) causal, its backward, and ssd_scan and its backward at
    mamba2-1.3b's (4, 1024, 64, 64), G 1, N 128, at chunk 128."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    ops = torch.ops.repro_torch
    with FakeTensorMode():
        q = torch.empty((4, 1024, 40, 128), dtype=torch.bfloat16)
        k = torch.empty((4, 1024, 8, 128), dtype=torch.bfloat16)
        lse = torch.empty((4, 40, 1024))
        x = torch.empty((4, 1024, 64, 64))
        dt = torch.empty((4, 1024, 64))
        a = torch.empty((4, 64))
        bm = torch.empty((4, 1024, 1, 128))
        counts = {}
        for name, call in (
                ("flash_attention", lambda: ops.flash_attention(
                    q, k, k, True, 0, True)),
                ("flash_attention_bwd", lambda: ops.flash_attention_bwd(
                    q, k, k, q, lse, q, True, 0)),
                ("ssd_scan", lambda: ops.ssd_scan(x, dt, a, bm, bm)),
                ("ssd_scan_bwd", lambda: ops.ssd_scan_bwd(
                    x, dt, a, bm, bm, x, torch.empty((4, 64, 64, 128)),
                    128))):
            with FlopCounterMode(display=False) as fc:
                call()
            counts[name] = fc.get_total_flops()
    assert counts == {"flash_attention": 42_991_616_000,
                      "flash_attention_bwd": 107_479_040_000,
                      "ssd_scan": 13_019_119_616,
                      "ssd_scan_bwd": 30_467_424_256}
    assert [round(v / 1e9, 1) for v in counts.values()] == [43.0, 107.5, 13.0,
                                                            30.5]
    assert roofline.live_pairs(10, True, 4) == sum(min(i + 1, 4)
                                                   for i in range(10))
    assert roofline.live_pairs(10, False, 0) == 100


def _counter_run(gm):
    """``FlopCounterMode`` over a run of ``gm`` on its own fake inputs
    (under their mode: nothing allocated): the sum ``graph_flops`` must
    give without running the graph."""
    from torch.utils.flop_counter import FlopCounterMode
    inputs = [n.meta["val"] for n in gm.graph.nodes if n.op == "placeholder"]
    with inputs[0].fake_mode, FlopCounterMode(display=False) as fc:
        gm(*inputs)
    return fc.get_total_flops()


def test_traced_prefill_flops_equal_the_count_from_the_config():
    cfg = get_config("qwen3-14b").reduced()
    b, s = 2, 48
    step, args = steps.make_prefill_step(cfg, InputShape("p", s, b,
                                                         "prefill"))
    gm = dryrun.trace_step(step, args)
    assert dryrun.kernel_nodes(gm)["flash_attention"] == cfg.num_layers
    d, h, kv, hd, ff, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
    per_layer = (2 * b * s * (2 * d * h * hd + 2 * d * kv * hd + 3 * d * ff)
                 + 4 * b * h * hd * s * (s + 1) // 2)
    want = cfg.num_layers * per_layer + 2 * b * d * v   # unembed: last token
    got = roofline.graph_flops(gm)
    assert got["total"] == want == _counter_run(gm)
    assert got["flash_attention"] == cfg.num_layers * 4 * b * h * hd * (
        s * (s + 1) // 2)
    rl = roofline.extract_roofline("qwen3-14b", InputShape("p", s, b,
                                                           "prefill"),
                                   mesh.ONE_CARD, 1, gm, cfg)
    assert rl.flops_per_device == want and rl.collective_bytes_per_device == 0
    assert 0 < rl.bytes_per_device and 0 < rl.peak_memory_per_device
    # The params and the caches the step returns are live at its end.
    caches = 2 * cfg.num_layers * b * s * kv * hd * 2     # bf16 K and V
    assert rl.peak_memory_per_device >= steps.param_count(cfg) * 2 + caches
    # The least traffic: the params read, the caches written.
    assert rl.bytes_per_device == steps.param_count(cfg) * 2 + b * s * 4 \
        + caches + b * 4
    assert rl.eager_bytes_per_device > rl.bytes_per_device
    # The reference's keys, and the eager program's traffic beside them.
    assert set(rl.to_dict()) - set(jroofline.Roofline(
        "a", "s", "m", 1, 0., 0., 0., {}, 0., 0.).to_dict()) == {
            "eager_bytes_per_device", "t_eager_memory_s"}


def test_serve_step_least_bytes_equal_the_count_from_the_config():
    """The memory term of one token: the params and the full caches read
    once, one K and V slot a layer written, the tokens in and out."""
    cfg = get_config("qwen3-14b").reduced()
    b, s = 2, 64
    step, args = steps.make_serve_step(cfg, InputShape("d", s, b, "decode"))
    gm = dryrun.trace_step(step, args)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    caches = 2 * cfg.num_layers * b * s * kv * hd * 2     # bf16 K and V
    slots = 2 * cfg.num_layers * b * kv * hd * 2
    assert roofline.min_bytes(gm) == (steps.param_count(cfg) * 2 + caches
                                      + slots + 2 * b * 4)
    assert roofline.eager_bytes(gm) > roofline.min_bytes(gm)


def test_traced_train_step_is_three_forwards():
    cfg = get_config("qwen3-14b").reduced()
    shape = InputShape("t", 32, 2, "train")
    step, args = dryrun.build_step(cfg, shape, microbatches=1)
    gm = dryrun.trace_step(step, args)
    train = roofline.graph_flops(gm)
    assert train["total"] == _counter_run(gm)
    fwd = roofline.graph_flops(dryrun.trace_step(
        lambda p, batch: loss_fn(p, cfg, batch)[0], (args[0], args[2])))
    assert train["flash_attention_bwd"] == 5 * train["flash_attention"] // 2
    assert 0.95 <= train["total"] / (3 * fwd["total"]) <= 1.05


def test_traced_mamba_train_step_holds_one_backward_node_a_layer():
    """A reduced mamba2 train step traced over fake tensors: one ssd_scan
    and one ssd_scan_bwd node a Mamba layer, and none of the plain chunked
    form's (its cumsum and its vjp's) in the graph."""
    cfg = get_config("mamba2-1.3b").reduced()
    shape = InputShape("t", 32, 2, "train")
    step, args = dryrun.build_step(cfg, shape, microbatches=1)
    gm = dryrun.trace_step(step, args)
    nodes = dryrun.kernel_nodes(gm)
    assert nodes["ssd_scan"] == nodes["ssd_scan_bwd"] == cfg.num_layers
    assert sum(nodes.values()) == 2 * cfg.num_layers
    targets = {str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"}
    assert not any("cumsum" in t for t in targets), sorted(targets)
    flops = roofline.graph_flops(gm, cfg.ssm_chunk)
    assert flops["ssd_scan_bwd"] == cfg.num_layers * roofline.ssd_bwd_flops(
        (2, 32, cfg.ssm_heads, cfg.ssm_head_dim),
        (2, 32, cfg.ssm_groups, cfg.ssm_state), cfg.ssm_chunk)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-moe-1b-a400m"])
def test_grads_only_dryrun_is_the_train_step_less_the_optimizer(arch):
    """A reduced train step's record with ``grads_only``: the same kernel
    nodes (one forward and one backward node a mixer layer), a peak no
    higher than the whole step's (which also holds the AdamW moments), and
    ``make_grad_step``'s gradients equal the train step's first
    microbatch's own."""
    cfg = get_config(arch).reduced(num_layers=4, moe_dropless=False)
    shape = InputShape("t", 32, 2, "train")
    full = dryrun.dryrun_step(arch, cfg, shape, microbatches=1)
    grads = dryrun.dryrun_step(arch, cfg, shape, grads_only=True)
    assert grads["grads_only"] and not full["grads_only"]
    assert grads["microbatches"] == 1
    assert grads["kernel_launches"] == full["kernel_launches"]
    assert sum(grads["kernel_launches"].values()) > 0
    assert grads["peak_memory_per_device"] <= full["peak_memory_per_device"]
    params = init_model(PRNGKey(4), cfg, device="cpu")
    g = np.random.default_rng(4)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    got, loss = steps.make_grad_step(cfg)(params, batch)
    leaves = {k: v.detach().requires_grad_()
              for k, v in flatten_params(params).items()}
    want_loss = loss_fn(unflatten_params(leaves), cfg, batch)[0]
    want = torch.autograd.grad(want_loss, list(leaves.values()))
    assert torch.equal(loss, want_loss.detach())
    assert list(got) == list(leaves)
    for a, b in zip(got.values(), want):
        assert torch.equal(a, b)


def test_run_serve_on_given_weights_serves_what_it_draws():
    """``run_serve(..., params=...)`` on the weights ``run_serve`` would draw
    (PRNGKey(0)) gives its tokens bit for bit."""
    from repro_torch.launch.serve import run_serve
    cfg = get_config("granite-moe-1b-a400m").reduced(vocab_size=512)
    params = init_model(PRNGKey(0), cfg, device="cpu")
    drawn, _, _ = run_serve("granite-moe-1b-a400m", 2, 12, 4, device="cpu")
    given, _, _ = run_serve("granite-moe-1b-a400m", 2, 12, 4, device="cpu",
                            params=params)
    assert torch.equal(drawn, given)


def test_dryrun_cli_runs_without_a_card(dryrun_cli):
    proc = dryrun_cli
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    record = json.loads(next(line for line in out.splitlines()
                             if line.startswith("{")))
    assert record["fits_one_card"] and record["mesh"] == "1xH100"
    assert record["params"] == steps.param_count(get_config("mamba2-1.3b"))
    assert record["collectives_by_kind"] == dict.fromkeys(
        roofline.COLLECTIVES, 0)
    assert not any(record["kernel_launches"].values())   # decode: plain


def test_fl_round_record_matches_the_reference_statics():
    """``--fl-round``: the reference's round at G = 16 ranks of one client,
    labelwise with half of them selected; its exchange bytes by the
    reference's own formula."""
    from repro.fl.sharded import exchange_bytes_per_device as jexchange
    rec = dryrun.dryrun_fl_round(save=False, verbose=False)
    g = rec["groups"]
    assert (g, rec["n_select"], rec["budget"]) == (16, 8, 8)
    slots = -(-rec["budget"] // g)
    assert rec["budget_padded"] == slots * g == rec["trained_per_round"]
    assert rec["flop_sparsity"] == 1.0 - rec["trained_per_round"] / g
    batch = {"images": jax.ShapeDtypeStruct((g, 64, 28, 28, 1), jnp.float32),
             "labels": jax.ShapeDtypeStruct((g, 64), jnp.int32),
             "valid": jax.ShapeDtypeStruct((g, 64), jnp.bool_)}
    for ex, got in rec["exchange_bytes_per_device"].items():
        assert got == jexchange(batch, g, rec["budget_padded"], g, ex)
