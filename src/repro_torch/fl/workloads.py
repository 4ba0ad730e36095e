"""Client workloads: what each FL client trains.

A :class:`Workload` bundles what the round loop needs to run one model family
over one label-conditioned synthetic data source.  Two are registered, as in
the reference: ``cnn``, the paper's CNN over class-conditional images, and
``lm``, a micro decoder-only transformer over domain-skewed token streams
(the plan's labels are vocab-band domain ids); ``lm_workload(cfg)`` builds
one around any dense or SSM ``ModelConfig``.

Every engine carries params as one flat ``dict[str, Tensor]``.  The LM's
params are nested (a per-layer ``stack.blocks`` list), so its workload keeps
them flat at the engine boundary (dotted names,
``models.transformer.flatten_params``) and unflattens them inside its loss
and eval: no engine knows which workload it runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from .. import rng
from ..data import (ImageDataset, TokenDataset, materialize_round,
                    round_histograms)
from ..models import cnn_init, cnn_loss, forward, init_model, loss_fn, token_ce
from ..models.config import ModelConfig
from ..models.transformer import flatten_params, unflatten_params

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
                      overwrite: bool = False,
                      check: bool = False) -> Workload:
    """Register ``workload`` under ``name`` (``overwrite=True`` replaces a
    registered one).  ``check=True``, the contract pass over the bundle, is
    not ported yet and raises."""
    if check:
        raise NotImplementedError(
            "register_workload(check=True), the contract pass over a "
            "workload, is not ported yet (ROADMAP Queue 1 item 16)")
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


# The reference's micro config for the registered ``lm`` workload: 2 layers,
# d 64, 4 heads of 16 (2 kv heads), float32.  Real sizes go through
# lm_workload(cfg).
MICRO_LM_CONFIG = ModelConfig(
    name="fl-lm-micro", arch_type="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
    fsdp=False, remat=False, scan_layers=False)


def _lm_targets(tokens: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Next-token targets: tokens rolled left, −1 at the last position and
    on every padded (invalid) sequence (−1 is the loss's ignore id)."""
    tgt = torch.roll(tokens, -1, dims=-1)
    tgt = torch.cat([tgt[..., :-1], torch.full_like(tgt[..., -1:], -1)], -1)
    return torch.where(valid[..., None], tgt, -1)


def _lm_tokens(ds: TokenDataset, key, labels: torch.Tensor,
               rows: "torch.Tensor | None" = None) -> Batch:
    """The token sequences of ``labels`` (rows ``rows`` of them), zeroed on
    padded slots, as the reference's materializer draws them."""
    toks = ds.sample(key, labels, rows)
    if rows is not None:
        labels = torch.gather(labels.long(), -2, rows.long()[..., None]
                              .expand(rows.shape + labels.shape[-1:]))
    return {"tokens": toks * (labels >= 0)[..., None]}


def lm_workload(cfg: ModelConfig, *, num_domains: int = 10,
                seq_len: int = 16, concentration: float = 0.85) -> Workload:
    """An LM workload around ``cfg``, as the reference's ``lm_workload``:
    clients hold ``seq_len``-token sequences from ``num_domains`` vocab-band
    domains (the plan's labels are domain ids); the local loss is next-token
    cross-entropy over a client's valid sequences; eval is the loss and
    top-1 next-token accuracy on a held-out uniform-domain stream
    (``n_per_class`` sequences a domain, drawn from ``PRNGKey(999)``)."""

    def make_dataset(device) -> TokenDataset:
        return TokenDataset(num_domains=num_domains,
                            vocab_size=cfg.vocab_size, seq_len=seq_len,
                            concentration=concentration, device=device)

    def _check(ds: TokenDataset) -> None:
        if ds.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"TokenDataset vocab_size ({ds.vocab_size}) must match the "
                f"workload model's vocab_size ({cfg.vocab_size})")

    def init(key, ds: TokenDataset) -> Params:
        _check(ds)
        return flatten_params(init_model(key, cfg, device=ds.device))

    def make_loss(ds: TokenDataset) -> LossFn:
        _check(ds)

        def loss(params: Params, batch: Batch):
            toks = batch["tokens"]
            return loss_fn(unflatten_params(params), cfg, {
                "tokens": toks, "targets": _lm_targets(toks, batch["valid"])})
        return loss

    def materialize(ds: TokenDataset, plan_t, key) -> Batch:
        data = round_histograms(ds, plan_t)
        return {**_lm_tokens(ds, key, data["labels"]), **data}

    def eval_set(ds: TokenDataset, n_per_class: int) -> Batch:
        domains = torch.arange(ds.num_domains,
                               device=ds.device).repeat(n_per_class)
        tokens = ds.sample(rng.PRNGKey(999), domains)
        ones = torch.ones(tokens.shape[0], dtype=torch.bool,
                          device=ds.device)
        return {"tokens": tokens, "targets": _lm_targets(tokens, ones)}

    def make_eval(ds: TokenDataset) -> LossFn:
        _check(ds)

        def ev(params: Params, batch: Batch):
            logits, _ = forward(unflatten_params(params), cfg,
                                {"tokens": batch["tokens"]})
            loss, m = token_ce(logits, batch["targets"], with_accuracy=True)
            return loss, {"accuracy": m["accuracy"], "n": m["ntok"]}
        return ev

    return Workload(
        name=f"lm:{cfg.name}",
        make_dataset=make_dataset,
        init=init,
        make_loss=make_loss,
        materialize=materialize,
        eval_set=eval_set,
        make_eval=make_eval,
        batch_keys=("tokens", "labels", "valid"),
        num_classes=lambda ds: ds.num_domains,
        hists=round_histograms,
        sample=_lm_tokens,
    )


LM_WORKLOAD = register_workload("lm", lm_workload(MICRO_LM_CONFIG))
