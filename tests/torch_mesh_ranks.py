"""Ranks of a ``gloo`` process group on the CPU for the mesh train step's
tests (``tests/test_torch_mesh_train.py``): not a test module itself.

    python tests/torch_mesh_ranks.py OUT_DIR CASES [--world 4]

starts ``--world`` processes, one rank each, joined through a file store
in OUT_DIR, each on one intra-op thread.  Every rank first holds
``ParamLayout``'s shard and gather to slicing and concatenating, on the
whole group and on groups of two, then runs each case of CASES (a JSON
list of ``{"arch", "over", "mb", "steps", "batch", "seq"}``) through
``make_train_step(cfg, shape, mb, mesh=make_debug_mesh(), fsdp=True)`` on
its rows of each step's global batch (``synth_lm_batch(...,
rows=batch_rows(...))``).  Rank 0 writes case i's losses, grad norms and
gathered params to OUT_DIR/case<i>.npz; every rank writes what its MoE
layers saw (each call's router input rows, router weight and aux loss, and
the capacity path's experts, sort order and kept assignments) to
OUT_DIR/case<i>_rank<r>.npz, and OUT_DIR/rank<r>.ok when it has passed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def check_layout(rank: int, world: int) -> None:
    """Shard then gather is the identity, and each block is the slice of
    its rank, at G = world and G = 2; a leaf whose EMBED size the group
    does not divide stays whole."""
    from repro_torch.launch.steps import param_layout
    from repro_torch.models import init_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import flatten_params
    cfg = ModelConfig(name="layout", arch_type="dense", num_layers=2,
                      d_model=12, num_heads=2, num_kv_heads=1, head_dim=6,
                      d_ff=10, vocab_size=7, qk_norm=True, dtype="float32")
    whole = flatten_params(init_model(None, cfg, device="cpu"))
    pairs = [dist.new_group([2 * i, 2 * i + 1]) for i in range(world // 2)]
    for group in (dist.group.WORLD, pairs[rank // 2]):
        g = dist.get_world_size(group)
        mesh = {"data": g, "model": 1}
        layout = dataclasses.replace(param_layout(cfg, mesh, True),
                                     group=group)
        assert layout.size == g and layout.rank == dist.get_rank(group)
        shards = layout.shard(whole)
        for k, x in whole.items():
            dim = layout.dims[k]
            if dim is None:
                assert shards[k] is x, k
            else:
                assert x.shape[dim] % g == 0, k
                assert torch.equal(shards[k],
                                   x.chunk(g, dim)[layout.rank]), k
        back = layout.gather(shards)
        assert all(torch.equal(back[k], whole[k]) for k in whole)
        # d_model 12 splits 4 and 2 ways, the 7-row table's EMBED columns
        # too; the head-dim norms have no EMBED axis and stay whole.
        assert layout.dims["embed.table"] == 1
        assert layout.dims["stack.blocks.0.attn.wo"] == 2
        assert layout.dims["stack.blocks.0.attn.q_norm"] is None
        odd = dataclasses.replace(cfg, d_model=10, head_dim=5)
        odd_layout = param_layout(odd, {"data": 4, "model": 1}, True)
        assert all(d is None for d in odd_layout.dims.values())


class MoERecorder:
    """Wraps ``layers.moe_apply`` and ``layers._capacity_plan`` and keeps
    what each call saw."""

    def __init__(self):
        from repro_torch.models import layers as L
        self.L = L
        self.calls = []
        self.plans = []
        self._moe, self._plan = L.moe_apply, L._capacity_plan

    def __enter__(self):
        def moe_apply(p, x, cfg):
            y, aux = self._moe(p, x, cfg)
            self.calls.append((x.detach().reshape(-1, x.shape[-1]).clone(),
                               p["router"].detach().clone(),
                               aux.detach().clone()))
            return y, aux

        def plan(flat_e, tokens, cfg):
            out = self._plan(flat_e, tokens, cfg)
            self.plans.append((flat_e.clone(), out[0].clone(),
                               out[3].clone()))
            return out

        self.L.moe_apply, self.L._capacity_plan = moe_apply, plan
        return self

    def __exit__(self, *exc):
        self.L.moe_apply, self.L._capacity_plan = self._moe, self._plan

    def arrays(self) -> dict:
        out = {}
        for i, (x, router, aux) in enumerate(self.calls):
            out.update({f"x{i}": x.numpy(), f"router{i}": router.numpy(),
                        f"aux{i}": aux.numpy()})
        for i, (flat_e, order, keep) in enumerate(self.plans):
            out.update({f"flat_e{i}": flat_e.numpy(),
                        f"order{i}": order.numpy(), f"keep{i}": keep.numpy()})
        return out


def run_case(rank: int, world: int, out: str, i: int, case: dict) -> None:
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import TokenDataset
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (batch_rows, make_train_step,
                                          param_layout)
    from repro_torch.launch.train import synth_lm_batch
    from repro_torch.models import init_model
    from repro_torch.models.transformer import flatten_params
    cfg = get_config(case["arch"]).reduced(**case["over"])
    mb, batch, seq = case["mb"], case["batch"], case["seq"]
    mesh = make_debug_mesh()
    step, opt = make_train_step(cfg, InputShape("c", seq, batch, "train"), mb,
                                mesh=mesh, fsdp=True)
    layout = param_layout(cfg, mesh, True)
    key = rng.PRNGKey(0)
    params = init_model(key, cfg, device="cpu", layout=layout)
    whole = layout.shard(flatten_params(init_model(key, cfg, device="cpu")))
    assert all(torch.equal(x, whole[k])
               for k, x in flatten_params(params).items())
    state = opt.init(flatten_params(params))
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=seq, device="cpu")
    rows = batch_rows(batch, mb, rank, world)
    losses, norms = [], []
    with MoERecorder() as rec:
        for s in range(case["steps"]):
            kb = rng.fold_in(key, s)
            mine = synth_lm_batch(ds, kb, batch, rows=rows)
            full = synth_lm_batch(ds, kb, batch)
            for k in mine:
                assert torch.equal(mine[k], full[k][rows]), k
            params, state, m = step(params, state, mine)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    np.savez(Path(out, f"case{i}_rank{rank}.npz"), **rec.arrays())
    gathered = layout.gather(flatten_params(params))
    if rank == 0:
        np.savez(Path(out, f"case{i}.npz"), losses=np.array(losses),
                 norms=np.array(norms),
                 **{f"p:{k}": v.numpy() for k, v in gathered.items()})


def _rank(rank: int, world: int, out: str, cases_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    try:
        check_layout(rank, world)
        cases = json.loads(Path(cases_file).read_text())
        for i, case in enumerate(cases):
            run_case(rank, world, out, i, case)
        Path(out, f"rank{rank}.ok").write_text("ok")
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("cases")
    ap.add_argument("--world", type=int, default=4)
    a = ap.parse_args()
    os.makedirs(a.out, exist_ok=True)
    mp.spawn(_rank, args=(a.world, a.out, a.cases), nprocs=a.world)


if __name__ == "__main__":
    main()
