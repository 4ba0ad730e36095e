"""Client workloads: what each FL client trains.

A :class:`Workload` bundles what the round loop needs to run one model family
over one label-conditioned synthetic data source.  This slice of the port
registers the paper's ``cnn`` workload; the ``lm`` workload comes with the LM
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from .. import rng
from ..data import ImageDataset, materialize_round, round_histograms
from ..models import cnn_init, cnn_loss

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class Workload:
    """One client workload.

    * ``make_dataset(device)`` — the default dataset on ``device``;
    * ``init(key, ds)`` — parameter init on the dataset's device from a
      ``repro_torch.rng`` key;
    * ``make_loss(ds)`` — ``loss(params, batch) -> (scalar, aux)`` over one
      client minibatch;
    * ``materialize(ds, plan_t, key)`` — (N, n_max) label plan row -> round
      batch with ``labels``, ``valid``, ``hists`` and the payload leaves
      named in ``batch_keys``;
    * ``hists(ds, plan_t)`` — (…, N, n_max) plan rows -> ``labels``,
      ``valid`` and ``hists`` only (what selection needs);
    * ``sample(ds, key, labels, rows)`` — the payload leaves of ``rows``
      (…, S) of (…, N, n_max) labels, bit-equal to ``materialize``'s rows
      (the grid engine draws only the selected clients);
    * ``eval_set(ds, n_per_class)`` / ``make_eval(ds)`` — held-out batch and
      ``eval(params, batch) -> (loss, {"accuracy": ...})``;
    * ``num_classes(ds)`` — histogram width."""
    name: str
    make_dataset: Callable[[Any], Any]
    init: Callable[[Any, Any], Params]
    make_loss: Callable[[Any], LossFn]
    materialize: Callable[[Any, Any, Any], Batch]
    eval_set: Callable[[Any, int], Batch]
    make_eval: Callable[[Any], LossFn]
    batch_keys: Tuple[str, ...]
    num_classes: Callable[[Any], int]
    hists: Callable[[Any, Any], Batch]
    sample: Callable[[Any, Any, torch.Tensor, torch.Tensor], Batch]


def materialize_rows(wl: Workload, ds: Any, plan_rows, key,
                     row_ids: torch.Tensor) -> Batch:
    """The round batch of a client subset: ``plan_rows`` (B, n_max) labels
    of the clients with global ids ``row_ids`` (B,), each row drawn as
    ``wl.materialize`` draws a one-client round under ``fold_in(key,
    row_ids[i])`` (the reference's per-row fallback, which its ``cnn``
    workload takes), so a client's data depends on (key, id) alone and any
    grouping of the rows gives the same data.  All rows' histograms take
    one ``label_hist`` launch and all rows' payloads one ``sample`` call."""
    row_ids = torch.as_tensor(row_ids, device=ds.device)
    data = wl.hists(ds, plan_rows)
    keys = rng.fold_in(rng.as_key(key, ds.device), row_ids)
    payload = wl.sample(ds, keys, data["labels"][:, None], None)
    return {**{k: v[:, 0] for k, v in payload.items()}, **data}


_WORKLOADS: Dict[str, Workload] = {}


def register_workload(name: str, workload: Workload, *,
                      overwrite: bool = False) -> Workload:
    if name in _WORKLOADS and not overwrite:
        raise ValueError(f"workload {name!r} is already registered; pass "
                         "overwrite=True to replace it")
    if workload.name != name:
        workload = dataclasses.replace(workload, name=name)
    _WORKLOADS[name] = workload
    return workload


def registered_workloads() -> Tuple[str, ...]:
    return tuple(_WORKLOADS)


def get_workload(workload: "str | Workload") -> Workload:
    if isinstance(workload, Workload):
        return workload
    try:
        return _WORKLOADS[workload]
    except KeyError:
        raise KeyError(f"unknown workload {workload!r}; have "
                       f"{registered_workloads()}") from None


def _cnn_init(key, ds: ImageDataset) -> Params:
    return cnn_init(key, num_classes=ds.num_classes,
                    image_size=ds.image_size, channels=ds.channels,
                    device=ds.device)


def _cnn_make_loss(ds: ImageDataset) -> LossFn:
    def loss(params: Params, batch: Batch):
        return cnn_loss(params, batch["images"], batch["labels"],
                        batch["valid"])
    return loss


def _cnn_eval_set(ds: ImageDataset, n_per_class: int) -> Batch:
    x, y = ds.test_set(n_per_class)
    return {"images": x, "labels": y}


def _cnn_make_eval(ds: ImageDataset) -> LossFn:
    def ev(params: Params, batch: Batch):
        return cnn_loss(params, batch["images"], batch["labels"])
    return ev


CNN_WORKLOAD = register_workload("cnn", Workload(
    name="cnn",
    make_dataset=lambda device: ImageDataset(device=device),
    init=_cnn_init,
    make_loss=_cnn_make_loss,
    materialize=materialize_round,
    eval_set=_cnn_eval_set,
    make_eval=_cnn_make_eval,
    batch_keys=("images", "labels", "valid"),
    num_classes=lambda ds: ds.num_classes,
    hists=round_histograms,
    sample=lambda ds, key, labels, rows: {
        "images": ds.sample(key, labels, rows)},
))
