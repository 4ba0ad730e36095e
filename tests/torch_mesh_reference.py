"""The reference's side of tests/test_torch_mesh_train.py: not a test
module itself.

    python tests/torch_mesh_reference.py OUT_DIR CASES [--devices N] [--which I,J]

runs case i of CASES (the JSON list that tests/torch_mesh_ranks.py takes)
through the reference's ``make_train_step(cfg, mesh, shape, mb,
fsdp=True)``, jitted on a (``--devices``, 1) mesh of host devices inside
its sharding context, on the global batches of ``synth_lm_batch`` under
``fold_in(PRNGKey(0), step)``, and writes its losses and final params (the
reference's leaves in order) to OUT_DIR/ref<i>.npz.  It imports JAX and
the reference only; the caller sets ``XLA_FLAGS`` for N devices.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import sharding as jsh  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.shapes import InputShape  # noqa: E402
from repro.data import TokenDataset  # noqa: E402
from repro.launch.steps import make_train_step  # noqa: E402
from repro.launch.train import synth_lm_batch  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.optim import OptState  # noqa: E402


def ref_steps(case: dict, mesh) -> tuple:
    """-> (the final params' leaves, each step's loss)."""
    cfg = get_config(case["arch"]).reduced(**case["over"])
    batch, seq = case["batch"], case["seq"]
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=seq)
    key = jax.random.PRNGKey(0)
    batches = [synth_lm_batch(ds, jax.random.fold_in(key, i), batch)
               for i in range(case["steps"])]
    fn, in_sh, out_sh, _, rules = make_train_step(
        cfg, mesh, InputShape("custom", seq, batch, "train"),
        microbatches=case["mb"], fsdp=True)
    # Jitted: the eager init's op-by-op compiles take seconds.
    params = jax.jit(lambda k: init_model(k, cfg)[0])(key)
    zeros = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda p: jnp.zeros(p.shape, jnp.float32), params)
    state = OptState(step=jnp.zeros((), jnp.int32), mu=zeros(), nu=zeros())
    losses = []
    with mesh, jsh.shard_ctx(mesh, rules):
        jitted = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        for b in batches:
            params, state, m = jitted(params, state, b)
            losses.append(float(m["loss"]))
    return [np.asarray(p) for p in jax.tree_util.tree_leaves(params)], losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("cases")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--which", default=None)
    a = ap.parse_args()
    cases = json.loads(Path(a.cases).read_text())
    which = (range(len(cases)) if a.which is None
             else [int(i) for i in a.which.split(",")])
    mesh = jax.make_mesh((a.devices, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    assert mesh.devices.size == a.devices
    for i in which:
        params, losses = ref_steps(cases[i], mesh)
        np.savez(Path(a.out, f"ref{i}.npz"), losses=np.array(losses),
                 **{f"p{j}": p for j, p in enumerate(params)})


if __name__ == "__main__":
    main()
