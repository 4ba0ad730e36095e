"""One-card dry-run: trace every (architecture × input shape) step over fake
tensors and record its roofline terms, without running it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape long_500k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-save
    PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-round

Mirrors ``repro/launch/dryrun.py``, which lowers and compiles each step on
the TPU production meshes.  Here the step of ``launch.steps`` (built with
``config_for_shape``'s config) is traced with ``make_fx`` over fake tensors
of a ``FakeTensorMode``: nothing is allocated, no kernel is built or
launched, and each kernel launch is one ``repro_torch`` op, so the graph is
the card's program on any host.  ``launch.roofline`` reads its FLOPs,
bytes, peak memory and collectives.  The fake tensors lie on ``cuda`` where
the torch build has CUDA.  A build without it cannot index a fake ``cuda``
tensor (Python indexing takes a CUDA device guard), so there they lie on
the CPU; the graph is the same, since every kernel op runs its fake form
whatever the device and nothing on the model path branches on the device
outside the ops.

A record holds the roofline, ``params``, ``microbatches``, ``trace_s``,
``fits_one_card`` (the estimated peak within ``HBM_BYTES``), the note of
``arch_shape_applicable``, each kernel op's nodes and FLOPs, the graph's
node count, ``remat`` and ``remat_policy`` and the CLI's ``overrides``.
``--remat-policy {full,dots}`` sets the config's policy, as the
reference's flag does.  A train step whose config rematerialises (the
published configs do; ``reduced()`` and whisper-tiny's do not) runs each
superblock under ``torch.utils.checkpoint``: the trace holds the recompute
in the backward (one more forward node of each checkpointed layer's
kernel), the liveness peak sees the activations freed between the forward
and the backward, and ``useful_flops_fraction`` falls by the recompute's
share.  Records go to
``experiments/dryrun_torch/<arch>__<shape>__1xH100[__tag].json``.

``--fl-round`` records the sharded FL round's static attributes (``mode``,
``budget``, ``trained_per_round``, ``flop_sparsity``) and the analytic
bytes a rank receives in its batch exchange, at the reference's G (16
ranks, the single-pod mesh's ``data`` axis) and its round batch, read from
``fl/sharded.py`` without a process group.  No collective is traced: the
port's collectives are ``torch.distributed`` calls on a live group, which a
trace on one host does not have.

Left out: ``--multi-pod``, ``--fsdp``, ``--tp``, ``--seq-parallel`` and
``--kv-policy``.  The dry-run traces one process's step on one card; the
port places across cards by running one process a rank
(``make_train_step(..., mesh=...)``: data parallelism with FSDP over
``data``, no tensor or sequence parallelism yet), so a mesh's record would
be a per-rank trace of that step, which this tool does not make yet.  Also
left out: ``--donate`` (the port's steps update caches in place and return
new params) and ``--attention-impl`` (both attention implementations run
the flash kernel).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from ..configs import ARCH_IDS, SHAPES, get_config
from ..configs.shapes import InputShape
from ..data.specs import input_specs
from ..models.config import ModelConfig
from ..models.transformer import stack_plan
from .mesh import HBM_BYTES, ONE_CARD, production_mesh
from .roofline import KERNEL_OPS, extract_roofline, graph_flops
from .steps import (abstract_opt_state, abstract_params,
                    arch_shape_applicable, config_for_shape,
                    default_microbatches, make_grad_step, make_prefill_step,
                    make_serve_step, make_train_step, param_count)

# make_fx runs torch.utils.checkpoint's selective policy as a compile trace
# (a proxy mode is active), which keeps every output and only tags each node
# with the policy for a partitioner.
DOTS_NOTE = ("remat_policy dots not traced: make_fx keeps every output of "
             "a selectively checkpointed superblock, so this graph's FLOPs "
             "and peak are those of the step without remat")
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def trace_device() -> torch.device:
    """``cuda`` where the torch build has CUDA, else the CPU (see the module
    note)."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "cpu")


def build_step(cfg: ModelConfig, shape: InputShape,
               microbatches: Optional[int] = None, grads_only: bool = False
               ) -> Tuple[Callable, Tuple[Any, ...]]:
    """The step of ``shape.kind`` and its abstract (``meta``) arguments:
    ``train_step(params, opt_state, batch)``, ``prefill_step(params,
    batch)`` or ``serve_step(params, tokens, caches)``; with ``grads_only``
    a train shape's ``grad_step(params, batch)`` (one microbatch's
    gradients, no optimizer state)."""
    if shape.kind == "train" and grads_only:
        batch, _ = input_specs(cfg, shape)
        return make_grad_step(cfg), (abstract_params(cfg), batch)
    if shape.kind == "train":
        step, _ = make_train_step(cfg, shape, microbatches)
        params = abstract_params(cfg)
        batch, _ = input_specs(cfg, shape)
        return step, (params, abstract_opt_state(cfg, params), batch)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape)
    return make_serve_step(cfg, shape)


def trace_step(step: Callable, args: Tuple[Any, ...],
               device: "str | torch.device | None" = None
               ) -> torch.fx.GraphModule:
    """The aten graph of ``step(*args)`` traced with ``make_fx`` over fake
    tensors on ``device`` (default :func:`trace_device`) of the shapes and
    dtypes of ``args``' tensors (``meta`` or real); ``args``' other leaves
    (a cache's ``idx``, an optimizer step) are fixed.  The graph's inputs
    are the tensor leaves in ``pytree`` order, its outputs the tensor
    leaves of what ``step`` returns."""
    device = torch.device(device) if device is not None else trace_device()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    leaves, spec = pytree.tree_flatten(args)
    where = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    with mode:
        fakes = [torch.empty(leaves[i].shape, dtype=leaves[i].dtype,
                             device=device) for i in where]

    def body(*tensors):
        full = list(leaves)
        for i, t in zip(where, tensors):
            full[i] = t
        out = step(*pytree.tree_unflatten(full, spec))
        return [x for x in pytree.tree_leaves(out)
                if isinstance(x, torch.Tensor)]

    return make_fx(body, tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*fakes)


def kernel_nodes(gm: torch.fx.GraphModule) -> Dict[str, int]:
    """Nodes of each ``repro_torch`` kernel op in ``gm``: its launches."""
    counts = Counter(
        node.target._overloadpacket.__name__ for node in gm.graph.nodes
        if node.op == "call_function"
        and isinstance(node.target, torch._ops.OpOverload)
        and node.target.namespace == "repro_torch")
    return {name: counts.get(name, 0) for name in KERNEL_OPS}


def dryrun_step(arch: str, cfg: ModelConfig, shape: InputShape,
                microbatches: Optional[int] = None,
                args: Optional[Tuple[Any, ...]] = None,
                device: "str | torch.device | None" = None,
                grads_only: bool = False) -> Dict[str, Any]:
    """The record of ``cfg``'s step at ``shape`` (any config and shape; the
    CLI's pairs go through :func:`dryrun_one`), traced over ``args`` when
    given (abstract or real arguments of the step), else over
    :func:`build_step`'s; ``grads_only`` traces a train shape's gradients
    without the optimizer (``launch.steps.make_grad_step``, one
    microbatch)."""
    _, note = arch_shape_applicable(cfg, shape)
    if (shape.kind == "train" and cfg.remat and cfg.remat_policy == "dots"
            and stack_plan(cfg)[2] > 1):
        note = "; ".join(filter(None, (note, DOTS_NOTE)))
    mb = 1 if grads_only else (microbatches
                               or default_microbatches(cfg, shape))
    t0 = time.perf_counter()
    step, built = build_step(cfg, shape, mb, grads_only)
    gm = trace_step(step, built if args is None else args, device)
    t1 = time.perf_counter()
    flops = graph_flops(gm, cfg.ssm_chunk)
    rl = extract_roofline(arch, shape, ONE_CARD, 1, gm, cfg,
                          flops=flops["total"])
    record = rl.to_dict()
    record.update({
        "note": note, "params": param_count(cfg),
        "microbatches": mb, "trace_s": t1 - t0,
        "fits_one_card": rl.peak_memory_per_device <= HBM_BYTES,
        "kernel_launches": kernel_nodes(gm),
        "kernel_flops": {k: v for k, v in flops.items() if k != "total"},
        "nodes": len(gm.graph.nodes),
        "remat": cfg.remat, "remat_policy": cfg.remat_policy,
        "grads_only": grads_only,
        "trace_device": str(next(n.meta["val"].device
                                 for n in gm.graph.nodes
                                 if n.op == "placeholder")),
    })
    return record


def dryrun_one(arch: str, shape_name: str, microbatches: Optional[int] = None,
               save: bool = True, verbose: bool = True,
               tag: str = "",
               device: "str | torch.device | None" = None,
               cfg_overrides: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Trace and record one (arch, shape) pair, its config's fields
    replaced by ``cfg_overrides`` (the CLI's ``--remat-policy``); see the
    module note."""
    shape = SHAPES[shape_name]
    cfg = config_for_shape(get_config(arch), shape)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    record = dryrun_step(arch, cfg, shape, microbatches, device=device)
    record["overrides"] = cfg_overrides or {}
    if verbose:
        print(f"[{arch} × {shape_name} × {ONE_CARD}] trace "
              f"{record['trace_s']:.1f}s  "
              f"flops {record['flops_per_device']:.3e}  "
              f"bytes {record['bytes_per_device']:.3e} (eager "
              f"{record['eager_bytes_per_device']:.3e})  "
              f"peak-mem {record['peak_memory_per_device'] / 1e9:.2f} GB  "
              f"fits_one_card={record['fits_one_card']}  "
              f"remat={record['remat'] and record['remat_policy']}  "
              f"useful_flops_fraction "
              f"{record['useful_flops_fraction']:.3f}  "
              f"dominant={record['dominant']}  launches "
              f"{ {k: v for k, v in record['kernel_launches'].items() if v} }",
              flush=True)
        print(json.dumps(record), flush=True)
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fname = f"{arch}__{shape_name}__{ONE_CARD}{suffix}.json"
        with open(os.path.join(OUT_DIR, fname), "w") as f:
            json.dump(record, f, indent=1)
    return record


# The reference's FL round dry-run: 64 samples a client, a budget of half
# the groups, labelwise selection, 10 classes.
FL_PER_GROUP, FL_CLASSES = 64, 10


def dryrun_fl_round(save: bool = True, verbose: bool = True
                    ) -> Dict[str, Any]:
    """The sharded FL round's static facts and exchange bytes at the
    reference's G (module note)."""
    from ..core import get_strategy
    from ..fl.sharded import exchange_bytes_per_device, round_plan
    g = production_mesh()["data"]
    n_select = max(1, g // 2)
    plan = round_plan(get_strategy("labelwise"), n_select, g, g, FL_CLASSES,
                      mode="gather")
    meta = torch.device("meta")
    batch = {"images": torch.empty((g, FL_PER_GROUP, 28, 28, 1),
                                   device=meta),
             "labels": torch.empty((g, FL_PER_GROUP), dtype=torch.int32,
                                   device=meta),
             "valid": torch.empty((g, FL_PER_GROUP), dtype=torch.bool,
                                  device=meta)}
    record = {
        "kind": "fl_round", "groups": g, "n_select": n_select,
        "mode": "gather", "budget": plan["budget"],
        "budget_padded": plan["budget_padded"],
        "trained_per_round": plan["trained_per_round"],
        "flop_sparsity": plan["flop_sparsity"],
        "exchange_bytes_per_device": {
            ex: exchange_bytes_per_device(batch, g, plan["budget_padded"], g,
                                          ex)
            for ex in ("a2a", "allgather")},
    }
    if verbose:
        print(f"[fl_round × {g} ranks] {json.dumps(record)}", flush=True)
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"fl_round__{g}ranks.json"),
                  "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fl-round", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat-policy", choices=["full", "dots"], default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)

    if args.fl_round:
        dryrun_fl_round(save=not args.no_save)
        return 0
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, --all or --fl-round")
    overrides = ({"remat_policy": args.remat_policy} if args.remat_policy
                 else None)
    failures = []
    for a, s in pairs:
        try:
            dryrun_one(a, s, microbatches=args.microbatches,
                       save=not args.no_save, tag=args.tag,
                       cfg_overrides=overrides)
        except Exception:
            traceback.print_exc()
            failures.append((a, s))
    if failures:
        print("FAILED:", failures)
        return 1
    print(f"dry-run OK for {len(pairs)} pair(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
