"""Ranks of a ``gloo`` process group on the CPU for the sharded engine's
tests (``tests/test_torch_sharded.py``): not a test module itself.

    python tests/torch_sharded_ranks.py OUT_DIR SPECS [--world 4]

starts ``--world`` processes, one rank each, joined through a file store
in OUT_DIR, each on one intra-op thread.  Every rank holds the collectives
of ``core.aggregation`` to their one-process definitions and the ``a2a``
exchange to the ``allgather`` one, then runs each spec of SPECS (a JSON
list of ``ExperimentSpec.to_dict()``) through ``run``.  Rank 0 writes each
result's ``to_json()`` to OUT_DIR/result_<i>.json, every other rank
asserts that its own result is the same, and every rank writes
OUT_DIR/rank<r>.ok when it has passed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _ints(g: np.random.Generator, shape, dtype=torch.float32):
    """Small integers as ``dtype``: every sum of them is exact in any
    order, so a collective's sum is held bit for bit."""
    return torch.from_numpy(g.integers(-8, 9, shape)).to(dtype)


def check_collectives(rank: int, world: int) -> None:
    """Each collective against its one-process definition, every rank's
    inputs rebuilt from its seed."""
    from repro_torch.core import aggregation as A
    group = dist.group.WORLD
    assert A.group_size(group) == world and A.group_rank(group) == rank
    blocks = [np.random.default_rng(100 + r) for r in range(world)]
    data = [{"x": _ints(g, (3, 5)), "h": _ints(g, (3, 2, 2), torch.bfloat16),
             "b": torch.from_numpy(g.random((3, 4)) > 0.5),
             "i": torch.from_numpy(g.integers(0, 9, (3, 2)).astype(np.int32)),
             "s": _ints(g, ())}
            for g in blocks]
    mine = data[rank]
    for k in ("x", "h", "b", "i"):
        got = A.all_gather_tiled(mine[k], group)
        want = torch.cat([d[k] for d in data])
        assert got.dtype == want.dtype and torch.equal(got, want), k
        assert torch.equal(A.gather_client_shards({k: mine[k]}, group)[k],
                           want), k
    assert torch.equal(A.all_gather_scores(mine["s"], group),
                       torch.stack([d["s"] for d in data]))
    for k in ("x", "h"):
        got = A.all_reduce_sum(mine[k], group)
        assert torch.equal(got, sum(d[k] for d in data)), k
    rs = [_ints(np.random.default_rng(200 + r), (2 * world, 5))
          for r in range(world)]
    got = A.reduce_scatter_tiled(rs[rank], group)
    assert torch.equal(got, sum(rs)[2 * rank:2 * rank + 2])
    stacked = torch.stack([d["x"] for d in data])           # (G, 3, 5)
    # The masked psum and the weighted mean against their formulas.
    w = torch.tensor([1.0, 0.0, 2.0, 3.0][:world])
    m = torch.tensor([1.0, 1.0, 0.0, 1.0][:world])
    got = A.psum_aggregate({"x": mine["x"]}, m[rank], group, w[rank])["x"]
    ww = (m * w)
    want = (ww[:, None, None] * stacked).sum(0) / ww.sum()
    assert torch.equal(got, want)
    sw = torch.from_numpy(np.random.default_rng(7).integers(
        0, 4, (world, 3)).astype(np.float32))
    got = A.psum_weighted_mean({"x": mine["x"]}, sw[rank], group)["x"]
    want = (sw[:, :, None] * stacked).sum((0, 1)) / sw.sum()
    assert torch.equal(got, want)
    zero = A.psum_weighted_mean({"x": mine["x"]}, torch.zeros(3), group)
    assert torch.equal(zero["x"], torch.zeros(5))
    # The O(B) exchange against gather-then-index, with a padded order.
    order = torch.from_numpy(np.random.default_rng(9).permutation(
        3 * world).astype(np.int32))[:2 * world]
    slots = 2
    tree = {k: mine[k] for k in ("x", "h", "b", "i")}
    got = A.exchange_selected_shards(tree, order, group, num_groups=world,
                                     per_group=3)
    gathered = A.gather_client_shards(tree, group)
    mine_slots = order[rank * slots:(rank + 1) * slots].long()
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], gathered[k][mine_slots]), k


def check_exchanges(rank: int, world: int) -> None:
    """One sharded round of the paper CNN (micro images), a2a against
    allgather: every output bit-identical."""
    from repro_torch import rng
    from repro_torch.core import case_label_plan
    from repro_torch.data import ImageDataset, client_batches
    from repro_torch.fl import get_workload, local_train, make_sharded_fl_round
    from repro_torch.models import cnn_init
    from repro_torch.optim import get_optimizer
    n, per = 4 * world, 4
    ds = ImageDataset(image_size=12, device="cpu")
    plan = case_label_plan("iid", 0, 1, n, samples_per_client=8, majority=6)
    labels_all = torch.as_tensor(plan[0], dtype=torch.int32)
    rows = torch.arange(rank * per, (rank + 1) * per)
    labels = labels_all[rows]
    key = rng.PRNGKey(3)
    block = {"images": ds.sample(rng.fold_in(key, 0), labels_all, rows),
             "labels": labels, "valid": labels >= 0}
    batches = client_batches(block, 4, ("images", "labels", "valid"))
    loss_fn = get_workload("cnn").make_loss(ds)
    opt = get_optimizer("adam", 1e-3)

    def local_step(params, batch):
        return local_train(params, opt, batch, loss_fn, 1)[0]

    params = cnn_init(rng.PRNGKey(1), image_size=12, device="cpu")
    outs = []
    for exchange in ("a2a", "allgather"):
        fn = make_sharded_fl_round(dist.group.WORLD, local_step, n_select=6,
                                   num_classes=10, num_clients=n,
                                   exchange=exchange)
        outs.append(fn(params, batches, block["labels"], block["valid"],
                       rng.fold_in(key, 1)))
    (pa, ia), (pb, ib) = outs
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(ia[k], ib[k]) for k in ia)
    assert not all(torch.equal(pa[k], params[k]) for k in pa)


def _rank(rank: int, world: int, out: str, specs_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    try:
        from repro_torch.fl import ExperimentSpec, run
        check_collectives(rank, world)
        check_exchanges(rank, world)
        specs = json.loads(Path(specs_file).read_text())
        for i, d in enumerate(specs):
            res = run(ExperimentSpec.from_dict(d), device="cpu")
            got = res.to_json()
            if rank == 0:
                Path(out, f"result_{i}.json").write_text(got)
            dist.barrier()
            want = json.loads(Path(out, f"result_{i}.json").read_text())
            mine = json.loads(got)
            for name in ("accuracy", "loss", "num_selected"):
                assert mine[name] == want[name], (rank, i, name)
            for name in ("sharded", "clustered"):
                assert mine["meta"].get(name) == want["meta"].get(name), (
                    rank, i, name)
        Path(out, f"rank{rank}.ok").write_text("ok")
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("specs")
    ap.add_argument("--world", type=int, default=4)
    a = ap.parse_args()
    os.makedirs(a.out, exist_ok=True)
    mp.spawn(_rank, args=(a.world, a.out, a.specs), nprocs=a.world)


if __name__ == "__main__":
    main()
