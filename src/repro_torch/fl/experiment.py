"""Declarative experiment API: scenario specs × strategy registry × one
``run`` surface (mirrors ``repro.fl.experiment``).

    spec = ExperimentSpec(
        scenarios=tuple(ScenarioSpec.from_case(c, per_seed_plans=True)
                        for c in CASES),
        strategies=("random", "labelwise", "kl"),
        seeds=tuple(range(5)),
        engine="sim")                       # or "host"
    res = run(spec)                         # one labeled ExperimentResult
    res.table1(); res.success_rate()        # paper renderers
    res.to_json()                           # round-trips via from_json

Specs and results read and write the reference's dictionaries and JSON:
``ExperimentSpec.from_dict`` takes a reference ``to_dict()``, and each side's
``ExperimentResult.from_json`` loads the other's ``to_json()``.  Scenario
transforms lower on the host with the reference's NumPy draws and seed
schedule, so plans and availability masks are bit-equal.

Engines: ``"sim"`` is the batched grid (``fl.sim``: every trial of the grid
in one round loop, one ``label_hist`` launch a round and one ``weighted_agg``
launch a round, or one a cluster for a clustered family); ``"host"`` runs
:func:`~repro_torch.fl.loop.run_fl_host` per grid cell, the parity oracle.
Both run every aggregation family of the registry (clustered and robust),
the engine-level adversary behaviors and round telemetry.  ``"hier"`` (the
two-tier block rounds) and ``"async"`` (FedBuff windows) are the population
engines of ``fl.population``, a trial at a time, with single-model,
block-separable selection and round telemetry (``async`` also
``staleness_hist``); ``meta["population"]`` holds their side facts.
``run`` folds the metric series, the engines' side facts, the trace spans
and the peak device memory into the reference's ``meta["telemetry"]``
envelope.  ``"sharded"`` is the gather-based round over a
``torch.distributed`` process group (``fl.sharded``; one group without
one), with ``meta["sharded"]``.  ``validate(deep=True)`` runs the contract
passes of ``repro_torch.analysis`` over the entries a spec resolves.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import FLConfig
from ..core import (CASES, SAMPLES_PER_CLIENT, SelectionResult, STRATEGIES,
                    adversary_mask, apply_availability, availability_plan,
                    bias_mix_plan, case_label_plan, dirichlet_plan,
                    flip_labels, get_aggregator, get_strategy, quantity_skew,
                    register_strategy, topn_mask)
from ..core.ordered import class_dot, class_sum, digamma
from ..device import resolve_device
from ..obs import (build_envelope, get_metric, memory_snapshots, profiler,
                   record_duration, record_memory_analysis, series_arrays,
                   span, span_summary, write_trace)

# ---------------------------------------------------------------------------
# Transform registry: kind -> lowering fn(plan, avail, seed, **params)
# ---------------------------------------------------------------------------
TransformFn = Callable[..., Tuple[np.ndarray, Optional[np.ndarray]]]

_TRANSFORMS: Dict[str, TransformFn] = {}


def register_transform(kind: str, fn: TransformFn, *,
                       overwrite: bool = False) -> TransformFn:
    """Register a scenario transform lowering under ``kind``."""
    if not kind or not isinstance(kind, str):
        raise ValueError(f"transform kind must be a non-empty str; got {kind!r}")
    if kind in _TRANSFORMS and not overwrite:
        raise ValueError(f"transform {kind!r} already registered")
    if not callable(fn):
        raise TypeError(f"transform {kind!r} must be callable; got {type(fn)}")
    _TRANSFORMS[kind] = fn
    return fn


def registered_transforms() -> Tuple[str, ...]:
    return tuple(_TRANSFORMS)


def _lower_availability(plan: np.ndarray, avail: Optional[np.ndarray],
                        seed: int, *, p_drop: float, min_available: int = 1,
                        rounds: int, mode: str = "compose"):
    """Per-round client dropout over the experiment's horizon: folded into
    the plan (``mode="compose"``, dark labels -> −1) or carried as a (T, N)
    mask the grid engine applies to the histograms (``mode="mask"``)."""
    mask = availability_plan(seed, rounds, plan.shape[1], p_drop,
                             min_available=min_available)
    if mode == "compose":
        return apply_availability(plan, mask), avail
    if mode != "mask":
        raise ValueError(f"availability mode must be 'compose' or 'mask'; "
                         f"got {mode!r}")
    m = mask.astype(np.float32)
    avail = m if avail is None else (avail * m)
    return plan, avail


def _lower_quantity_skew(plan: np.ndarray, avail: Optional[np.ndarray],
                         seed: int, *, n_min: int = 30,
                         n_max: Optional[int] = None, rounds: int):
    del rounds
    return quantity_skew(plan, seed, n_min=n_min, n_max=n_max), avail


def _lower_label_flip(plan: np.ndarray, avail: Optional[np.ndarray],
                      seed: int, *, frac: float, num_classes: int = 10,
                      rounds: int):
    """Plan-level label poisoning: a fixed ``adversary_mask(frac)`` client
    subset reports ℓ -> C−1−ℓ in every round (−1 padding untouched)."""
    del rounds
    adv = adversary_mask(seed, plan.shape[1], frac)
    return flip_labels(plan, adv, num_classes=num_classes), avail


register_transform("availability", _lower_availability)
register_transform("quantity_skew", _lower_quantity_skew)
register_transform("label_flip", _lower_label_flip)


@dataclasses.dataclass(frozen=True, eq=False)
class TransformSpec:
    """One step of a scenario's ordered transform stack.  ``params`` may pin
    a ``seed``; otherwise the scenario's seed schedule supplies one."""
    kind: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TransformSpec":
        return cls(kind=d["kind"], params=dict(d.get("params", {})))


def availability(p_drop: float, **params: Any) -> TransformSpec:
    """Sugar: TransformSpec("availability", p_drop=...)."""
    return TransformSpec("availability", {"p_drop": p_drop, **params})


def quantity(n_min: int = 30, n_max: Optional[int] = None,
             **params: Any) -> TransformSpec:
    """Sugar: TransformSpec("quantity_skew", n_min=..., n_max=...)."""
    return TransformSpec("quantity_skew",
                         {"n_min": n_min, "n_max": n_max, **params})


def label_flip(frac: float, **params: Any) -> TransformSpec:
    """Sugar: TransformSpec("label_flip", frac=...)."""
    return TransformSpec("label_flip", {"frac": frac, **params})


# ---------------------------------------------------------------------------
# Scenario specs
# ---------------------------------------------------------------------------

_SOURCES = ("case", "bias_mix", "dirichlet", "plan")

# The reference's seed strides: between consecutive transforms' derived
# seeds, and from an experiment seed to its adversary-mask seed.
_TRANSFORM_SEED_STRIDE = 7919
_ADVERSARY_SEED_STRIDE = 104729

_ADVERSARY_KEYS = frozenset({"frac", "behaviors", "scale", "tau", "seed"})


@dataclasses.dataclass(frozen=True, eq=False)
class ScenarioSpec:
    """One data scenario: a plan *source* (``case``, ``bias_mix``,
    ``dirichlet`` or an explicit ``plan``) plus an ordered transform stack.
    ``per_seed_plans=True`` re-draws the source for each experiment seed s
    from ``seed0 + s``."""
    name: str
    source: str = "case"
    case: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    transforms: Tuple[TransformSpec, ...] = ()
    seed0: int = 0
    per_seed_plans: bool = False
    plan: Optional[np.ndarray] = None
    avail: Optional[np.ndarray] = None

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_case(cls, case: str, *, name: Optional[str] = None,
                  transforms: Sequence[TransformSpec] = (), seed0: int = 0,
                  per_seed_plans: bool = False, **params: Any) -> "ScenarioSpec":
        if case not in CASES:
            raise ValueError(f"unknown case {case!r}; have {CASES}")
        return cls(name=name or case, source="case", case=case,
                   params=dict(params), transforms=tuple(transforms),
                   seed0=seed0, per_seed_plans=per_seed_plans)

    @classmethod
    def from_bias_mix(cls, p_bias: float, *, name: Optional[str] = None,
                      transforms: Sequence[TransformSpec] = (), seed0: int = 0,
                      per_seed_plans: bool = False, **params: Any) -> "ScenarioSpec":
        return cls(name=name or f"bias{p_bias}", source="bias_mix",
                   params={"p_bias": p_bias, **params},
                   transforms=tuple(transforms), seed0=seed0,
                   per_seed_plans=per_seed_plans)

    @classmethod
    def from_dirichlet(cls, alpha: float, *, name: Optional[str] = None,
                       transforms: Sequence[TransformSpec] = (), seed0: int = 0,
                       per_seed_plans: bool = False, **params: Any) -> "ScenarioSpec":
        return cls(name=name or f"dirichlet{alpha}", source="dirichlet",
                   params={"alpha": alpha, **params},
                   transforms=tuple(transforms), seed0=seed0,
                   per_seed_plans=per_seed_plans)

    @classmethod
    def from_plan(cls, name: str, plan: np.ndarray, *,
                  avail: Optional[np.ndarray] = None,
                  transforms: Sequence[TransformSpec] = (),
                  seed0: int = 0) -> "ScenarioSpec":
        plan = np.asarray(plan, np.int32)
        if plan.ndim not in (3, 4):
            raise ValueError(f"explicit plan must be (T, N, n) or "
                             f"(R, T, N, n); got {plan.shape}")
        return cls(name=name, source="plan", plan=plan,
                   avail=None if avail is None else np.asarray(avail),
                   transforms=tuple(transforms), seed0=seed0,
                   per_seed_plans=plan.ndim == 4)

    # -- lowering -----------------------------------------------------------
    def _base_plan(self, fl_cfg, seed: int, rounds: int) -> np.ndarray:
        p = self.params
        if self.source == "case":
            spc = p.get("samples_per_client", SAMPLES_PER_CLIENT)
            return case_label_plan(
                self.case, seed=seed, num_rounds=rounds,
                num_clients=fl_cfg.num_clients,
                num_classes=p.get("num_classes", 10), samples_per_client=spc,
                majority=p.get("majority", int(spc * 200 / 290)))
        if self.source == "bias_mix":
            return bias_mix_plan(
                seed, fl_cfg.num_clients, p_bias=p["p_bias"],
                num_classes=p.get("num_classes", 10),
                n_min=p.get("n_min", 30), n_max=p.get("n_max", 270),
                num_rounds=p.get("num_rounds", 1))
        if self.source == "dirichlet":
            return dirichlet_plan(
                seed, fl_cfg.num_clients, alpha=p["alpha"],
                num_classes=p.get("num_classes", 10),
                samples_per_client=p.get("samples_per_client",
                                         SAMPLES_PER_CLIENT))
        raise ValueError(f"unknown scenario source {self.source!r}; "
                         f"have {_SOURCES}")

    def _lower_one(self, fl_cfg, seed_offset: int, rounds: int
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if self.source == "plan":
            plan = np.asarray(self.plan, np.int32)
            if plan.ndim == 4:
                plan = plan[seed_offset]
        else:
            plan = self._base_plan(fl_cfg, self.seed0 + seed_offset, rounds)
        avail = (None if self.avail is None
                 else np.asarray(self.avail, np.float32))
        for ti, t in enumerate(self.transforms):
            fn = _TRANSFORMS.get(t.kind)
            if fn is None:
                raise KeyError(f"unknown transform {t.kind!r}; have "
                               f"{registered_transforms()}")
            params = dict(t.params)
            seed = params.pop("seed", None)
            if seed is None:
                seed = (self.seed0 + seed_offset
                        + _TRANSFORM_SEED_STRIDE * (ti + 1))
            plan, avail = fn(plan, avail, seed, rounds=rounds, **params)
        return plan, avail

    def lower(self, fl_cfg, seeds: Sequence[int], rounds: int
              ) -> "LoweredScenario":
        """Host arrays: the (T, N, n) plan, or (R, T, N, n) when per-seed,
        plus an optional (T, N) availability mask."""
        if self.per_seed_plans:
            if self.source == "plan" and self.plan.shape[0] != len(seeds):
                raise ValueError(
                    f"scenario {self.name!r}: per-seed plans axis 0 "
                    f"({self.plan.shape[0]}) must match len(seeds) "
                    f"({len(seeds)})")
            pairs = [self._lower_one(fl_cfg, (s if self.source != "plan"
                                              else i), rounds)
                     for i, s in enumerate(seeds)]
            plans = np.stack([p for p, _ in pairs])
            avails = [a for _, a in pairs]
            if any(a is not None for a in avails):
                if any(a is None for a in avails):
                    raise ValueError(
                        f"scenario {self.name!r}: mask-mode transforms must "
                        "apply to every per-seed draw or none")
                first = avails[0]
                for a in avails[1:]:
                    if not np.array_equal(first, a):
                        raise ValueError(
                            f"scenario {self.name!r}: per-seed availability "
                            "masks diverge; pin them with an explicit "
                            "transform seed or use mode='compose'")
                return LoweredScenario(self.name, plans, first, True)
            return LoweredScenario(self.name, plans, None, True)
        if self.source == "plan" and np.asarray(self.plan).ndim == 4:
            raise ValueError(f"scenario {self.name!r}: (R, T, N, n) plans "
                             "imply per_seed_plans=True")
        plan, avail = self._lower_one(fl_cfg, 0, rounds)
        return LoweredScenario(self.name, plan, avail, False)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "source": self.source, "case": self.case,
            "params": dict(self.params),
            "transforms": [t.to_dict() for t in self.transforms],
            "seed0": self.seed0, "per_seed_plans": self.per_seed_plans,
            "plan": None if self.plan is None else np.asarray(self.plan).tolist(),
            "avail": None if self.avail is None else np.asarray(self.avail).tolist(),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ScenarioSpec":
        return cls(
            name=d["name"], source=d.get("source", "case"),
            case=d.get("case"), params=dict(d.get("params", {})),
            transforms=tuple(TransformSpec.from_dict(t)
                             for t in d.get("transforms", ())),
            seed0=d.get("seed0", 0),
            per_seed_plans=d.get("per_seed_plans", False),
            plan=(None if d.get("plan") is None
                  else np.asarray(d["plan"], np.int32)),
            avail=(None if d.get("avail") is None
                   else np.asarray(d["avail"], np.float32)))


@dataclasses.dataclass(frozen=True)
class LoweredScenario:
    """A ScenarioSpec lowered to arrays, ready for any engine."""
    name: str
    plan: np.ndarray                      # (T, N, n) or (R, T, N, n)
    avail: Optional[np.ndarray]           # (T_a, N) float mask or None
    per_seed: bool

    def composed_plan(self, seed_index: int) -> np.ndarray:
        """(T, N, n) plan of one grid cell with any mask-mode availability
        folded in — what the host loop consumes."""
        plan = self.plan[seed_index] if self.per_seed else self.plan
        if self.avail is not None:
            plan = apply_availability(plan, self.avail.astype(bool))
        return plan


# ---------------------------------------------------------------------------
# Experiment spec + result
# ---------------------------------------------------------------------------

def _jsonable_adversary(adv: Mapping[str, Any]) -> Dict[str, Any]:
    out = dict(adv)
    if "behaviors" in out:
        out["behaviors"] = list(out["behaviors"])
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class ExperimentSpec:
    """The full grid: scenarios × strategies × seeds × aggregation × engine
    × workload, with the reference's fields and dictionary form."""
    scenarios: Tuple[ScenarioSpec, ...]
    strategies: Tuple[str, ...] = ("labelwise",)
    seeds: Tuple[int, ...] = (0,)
    engine: str = "sim"
    fl: Any = dataclasses.field(default_factory=FLConfig)
    aggregation: Optional[str] = None
    rounds: Optional[int] = None
    eval_n_per_class: int = 50
    workload: str = "cnn"
    engine_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    telemetry: Tuple[str, ...] = ()
    adversary: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_rounds(self) -> int:
        return self.fl.global_epochs if self.rounds is None else self.rounds

    def validate(self, deep: bool = False, ds=None, device=None) -> None:
        """The reference's name-level pass: unknown strategy, engine,
        aggregator, workload, transform or metric names, undeclared
        ``engine_options`` keys and adversary behaviors an aggregation family
        cannot take raise.  ``deep=True`` then runs the contract passes
        (``repro_torch.analysis.check_spec``) on exactly the entries the
        spec resolves, over ``ds`` (default: the workload's dataset) on
        ``device`` (``None``: the card), and raises
        ``repro_torch.analysis.ContractError`` on errors."""
        if not self.scenarios:
            raise ValueError("spec needs at least one scenario")
        names = [s.name for s in self.scenarios]
        if len(set(names)) != len(names):
            raise ValueError(f"scenario names must be unique; got {names}")
        for sc in self.scenarios:
            for t in sc.transforms:
                if t.kind not in _TRANSFORMS:
                    raise KeyError(
                        f"scenario {sc.name!r}: unknown transform kind "
                        f"{t.kind!r}; have {registered_transforms()}")
        if not self.strategies:
            raise ValueError("spec needs at least one strategy")
        for s in self.strategies:
            get_strategy(s)
        if not self.seeds:
            raise ValueError("spec needs at least one seed")
        if self.engine not in _ENGINES:
            raise KeyError(f"unknown engine {self.engine!r}; have "
                           f"{engines()}")
        accepted = _ENGINE_OPTION_KEYS.get(self.engine)
        if accepted is not None:
            unknown = sorted(set(self.engine_options) - set(accepted))
            if unknown:
                raise ValueError(
                    f"engine {self.engine!r} does not accept engine_options "
                    f"key(s) {unknown}; it declares "
                    f"{sorted(accepted) or '(no options)'}")
        agg = get_aggregator(self.aggregation or self.fl.aggregation)
        if self.adversary:
            unknown = sorted(set(self.adversary) - _ADVERSARY_KEYS)
            if unknown:
                raise ValueError(f"unknown adversary key(s) {unknown}; have "
                                 f"{sorted(_ADVERSARY_KEYS)}")
            frac = float(self.adversary.get("frac", 0.0))
            if not 0.0 <= frac <= 1.0:
                raise ValueError(
                    f"adversary frac must be in [0, 1]; got {frac}")
            from .round import check_adversary, resolve_adversary
            poison_scale, tau = resolve_adversary(self.adversary)
            check_adversary(agg, poison_scale, tau)
            if (poison_scale is not None or tau > 0) and self.engine in (
                    "hier", "async"):
                raise ValueError(
                    f"engine {self.engine!r} does not support "
                    "engine-level adversary behaviors (poison/"
                    "stale_update); run on sim/host/sharded, or attack "
                    "the plan with the label_flip transform")
        from .workloads import get_workload
        get_workload(self.workload)
        for m in self.telemetry:
            if m != "auto":
                get_metric(m)
        if deep:
            from ..analysis import ContractError, check_spec
            findings = check_spec(self, ds=ds, device=device)
            if findings.errors():
                raise ContractError(findings)

    def adversary_masks(self) -> Optional[np.ndarray]:
        """The (R, N) per-seed 0/1 byzantine masks of the spec's adversary
        (the reference's schedule), or None without one."""
        if not self.adversary:
            return None
        frac = float(self.adversary.get("frac", 0.0))
        base = self.adversary.get("seed")
        return np.stack([
            adversary_mask(int(base) if base is not None
                           else int(s) + _ADVERSARY_SEED_STRIDE,
                           self.fl.num_clients, frac)
            for s in self.seeds])

    def to_dict(self) -> Dict[str, Any]:
        return {
            "scenarios": [s.to_dict() for s in self.scenarios],
            "strategies": list(self.strategies), "seeds": list(self.seeds),
            "engine": self.engine, "fl": dataclasses.asdict(self.fl),
            "aggregation": self.aggregation, "rounds": self.rounds,
            "eval_n_per_class": self.eval_n_per_class,
            "workload": self.workload,
            "engine_options": dict(self.engine_options),
            "telemetry": list(self.telemetry),
            "adversary": _jsonable_adversary(self.adversary),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        return cls(
            scenarios=tuple(ScenarioSpec.from_dict(s) for s in d["scenarios"]),
            strategies=tuple(d.get("strategies", ("labelwise",))),
            seeds=tuple(d.get("seeds", (0,))),
            engine=d.get("engine", "sim"),
            fl=FLConfig(**d["fl"]) if "fl" in d else FLConfig(),
            aggregation=d.get("aggregation"), rounds=d.get("rounds"),
            eval_n_per_class=d.get("eval_n_per_class", 50),
            workload=d.get("workload", "cnn"),
            engine_options=dict(d.get("engine_options", {})),
            telemetry=tuple(d.get("telemetry", ())),
            adversary=dict(d.get("adversary") or {}))


@dataclasses.dataclass
class ExperimentResult:
    """Labeled grid trajectories: axes (scenario, strategy, seed, round).
    ``meta`` carries engine side facts (JSON-able)."""
    scenarios: Tuple[str, ...]
    strategies: Tuple[str, ...]
    seeds: Tuple[int, ...]
    accuracy: np.ndarray        # (K, S, R, T) f32
    loss: np.ndarray
    num_selected: np.ndarray
    engine: str = "sim"
    wall_s: float = 0.0
    compile_s: float = 0.0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    AXES = ("scenario", "strategy", "seed", "round")

    def __post_init__(self):
        want = (len(self.scenarios), len(self.strategies), len(self.seeds))
        for name in ("accuracy", "loss", "num_selected"):
            arr = np.asarray(getattr(self, name))
            if arr.shape[:3] != want:
                raise ValueError(f"{name} leading axes {arr.shape[:3]} != "
                                 f"(scenarios, strategies, seeds) {want}")
            setattr(self, name, arr)

    def _idx(self, axis_labels: Sequence[Any], label: Any, axis: str) -> int:
        try:
            return list(axis_labels).index(label)
        except ValueError:
            raise KeyError(f"unknown {axis} {label!r}; have "
                           f"{tuple(axis_labels)}") from None

    def trajectory(self, scenario: str, strategy: str,
                   seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The (rounds,) trajectories of one grid cell (or a (R, rounds)
        block when ``seed`` is omitted)."""
        k = self._idx(self.scenarios, scenario, "scenario")
        s = self._idx(self.strategies, strategy, "strategy")
        sl = (k, s) if seed is None else (k, s, self._idx(self.seeds, seed,
                                                          "seed"))
        return {"accuracy": self.accuracy[sl], "loss": self.loss[sl],
                "num_selected": self.num_selected[sl]}

    @property
    def final_accuracy(self) -> np.ndarray:
        return self.accuracy[..., -1]

    def cluster_trajectories(self) -> Optional[Dict[str, np.ndarray]]:
        """A clustered family's detail from ``meta["clustered"]``:
        ``accuracy``/``loss`` (K, S, R, T, n_clusters) per-cluster-model
        trajectories and ``assign`` (K, S, R, T, N) round k-means
        assignments; None for a single-model family."""
        cl = self.meta.get("clustered")
        if cl is None:
            return None
        return {"n_clusters": int(cl["n_clusters"]),
                "accuracy": np.asarray(cl["cluster_accuracy"], np.float32),
                "loss": np.asarray(cl["cluster_loss"], np.float32),
                "assign": np.asarray(cl["cluster_assign"], np.int32)}

    def telemetry(self) -> Optional[Dict[str, np.ndarray]]:
        """The round-metric series of the ``meta["telemetry"]`` envelope as
        float64 arrays, ``{name: (K, S, R, rounds, …)}``; None when the run
        collected no metrics."""
        env = self.meta.get("telemetry")
        if not env or not env.get("series"):
            return None
        return series_arrays(env)

    def success_rate(self, threshold: float = 0.2) -> np.ndarray:
        """Paper Table II: fraction of seeds with final accuracy > τ; (K, S)."""
        return (self.final_accuracy > threshold).mean(axis=-1)

    def table1(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """Table-I data: scenario -> strategy -> final acc mean/std + loss."""
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for k, sc in enumerate(self.scenarios):
            out[sc] = {}
            for s, st in enumerate(self.strategies):
                fa = self.final_accuracy[k, s]
                out[sc][st] = {"acc_mean": float(fa.mean()),
                               "acc_std": float(fa.std()),
                               "loss_mean": float(self.loss[k, s, :, -1].mean())}
        return out

    def table2(self, threshold: float = 0.2) -> Dict[str, Dict[str, float]]:
        """Table-II data: scenario -> strategy -> train success rate."""
        sr = self.success_rate(threshold)
        return {sc: {st: float(sr[k, s])
                     for s, st in enumerate(self.strategies)}
                for k, sc in enumerate(self.scenarios)}

    def to_json(self, **json_kw: Any) -> str:
        return json.dumps({
            "axes": list(self.AXES),
            "scenarios": list(self.scenarios),
            "strategies": list(self.strategies),
            "seeds": [int(s) for s in self.seeds],
            "engine": self.engine,
            "wall_s": self.wall_s, "compile_s": self.compile_s,
            "meta": self.meta,
            "accuracy": self.accuracy.tolist(),
            "loss": self.loss.tolist(),
            "num_selected": self.num_selected.tolist(),
        }, **json_kw)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentResult":
        d = json.loads(s)
        return cls(
            scenarios=tuple(d["scenarios"]), strategies=tuple(d["strategies"]),
            seeds=tuple(d["seeds"]),
            accuracy=np.asarray(d["accuracy"], np.float32),
            loss=np.asarray(d["loss"], np.float32),
            num_selected=np.asarray(d["num_selected"], np.float32),
            engine=d.get("engine", "sim"), wall_s=d.get("wall_s", 0.0),
            compile_s=d.get("compile_s", 0.0), meta=d.get("meta", {}))


# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------
# An engine takes (spec, lowered_scenarios, ds, device) and returns
# (accuracy, loss, num_selected) arrays shaped (K, S, R, rounds), then
# (wall_s, compile_s) and optionally a JSON-able meta dict.
EngineFn = Callable[..., Tuple[np.ndarray, np.ndarray, np.ndarray, float, float]]

_ENGINES: Dict[str, EngineFn] = {}
_ENGINE_OPTION_KEYS: Dict[str, Optional[Tuple[str, ...]]] = {}


def register_engine(name: str, fn: EngineFn, *, overwrite: bool = False,
                    option_keys: Optional[Sequence[str]] = None) -> EngineFn:
    """Register an execution engine under ``name``; ``option_keys`` declares
    the ``engine_options`` keys it consumes (None accepts any)."""
    if not name or not isinstance(name, str):
        raise ValueError(f"engine name must be a non-empty str; got {name!r}")
    if name in _ENGINES and not overwrite:
        raise ValueError(f"engine {name!r} already registered")
    if not callable(fn):
        raise TypeError(f"engine {name!r} must be callable; got {type(fn)}")
    _ENGINES[name] = fn
    _ENGINE_OPTION_KEYS[name] = (None if option_keys is None
                                 else tuple(option_keys))
    return fn


def engines() -> Tuple[str, ...]:
    return tuple(_ENGINES)


def engine_option_keys(name: str) -> Optional[Tuple[str, ...]]:
    """The declared ``engine_options`` keys of engine ``name`` (None: it
    accepts any)."""
    if name not in _ENGINES:
        raise KeyError(f"unknown engine {name!r}; have {engines()}")
    return _ENGINE_OPTION_KEYS.get(name)


def _clustered_meta(c_acc: np.ndarray, c_loss: np.ndarray,
                    c_assign: np.ndarray) -> Dict[str, Any]:
    """The engines' clustered side facts, as the reference writes them:
    per-cluster trajectories (K, S, R, T, n_clusters) and round k-means
    assignments (K, S, R, T, N) as nested lists, so ``to_json`` round-trips
    them exactly."""
    c_acc = np.asarray(c_acc, np.float32)
    return {"clustered": {
        "n_clusters": int(c_acc.shape[-1]),
        "axes": ["scenario", "strategy", "seed", "round", "cluster"],
        "assign_axes": ["scenario", "strategy", "seed", "round", "client"],
        "cluster_accuracy": c_acc.tolist(),
        "cluster_loss": np.asarray(c_loss, np.float32).tolist(),
        "cluster_assign": np.asarray(c_assign, np.int32).tolist()}}


def _engine_sim(spec: ExperimentSpec, lowered: Sequence[LoweredScenario], ds,
                device):
    """The batched grid (``fl.sim.grid_arrays``): every (scenario, strategy,
    seed) trial in one round loop."""
    from .sim import grid_arrays
    shapes = {low.plan.shape[-3:] for low in lowered}
    if len(shapes) != 1:
        raise ValueError(
            "engine='sim' stacks every scenario into one grid, so all "
            "lowered plans must share (T, N, n); got "
            f"{ {low.name: low.plan.shape for low in lowered} } — pad plans "
            "to a common n_max or split into separate specs")
    per_seed = any(low.per_seed for low in lowered)
    r = len(spec.seeds)

    def cell(low: LoweredScenario) -> np.ndarray:
        if low.per_seed or not per_seed:
            return low.plan
        return np.broadcast_to(low.plan[None], (r,) + low.plan.shape)

    plans = np.stack([cell(low) for low in lowered])
    avail = None
    if any(low.avail is not None for low in lowered):
        a_shapes = {low.avail.shape for low in lowered
                    if low.avail is not None}
        if len(a_shapes) != 1:
            raise ValueError("engine='sim' stacks availability masks on the "
                             f"scenario axis; shapes must agree, got {a_shapes}")
        (t_a, n_a), = a_shapes
        avail = np.ones((len(lowered), t_a, n_a), np.float32)
        for k, low in enumerate(lowered):
            if low.avail is not None:
                avail[k] = low.avail
    res = grid_arrays(plans, spec.fl, strategies=spec.strategies,
                      seeds=spec.seeds, aggregation=spec.aggregation,
                      rounds=spec.rounds, ds=ds, avail=avail,
                      eval_n_per_class=spec.eval_n_per_class,
                      workload=spec.workload, telemetry=spec.telemetry,
                      adversary=spec.adversary or None,
                      adv=spec.adversary_masks(), device=device)
    record_memory_analysis("sim:grid", device)
    meta: Dict[str, Any] = {"sim": res.meta}
    if res.cluster_accuracy is not None:
        meta.update(_clustered_meta(res.cluster_accuracy, res.cluster_loss,
                                    res.cluster_assign))
    if res.telemetry:
        meta["_telemetry_series"] = res.telemetry
    return (res.accuracy, res.loss, res.num_selected, res.wall_s,
            res.compile_s, meta)


def _engine_host(spec: ExperimentSpec, lowered: Sequence[LoweredScenario], ds,
                 device):
    """The per-round host loop over every grid cell: the parity oracle."""
    from .loop import run_fl_host
    agg = get_aggregator(spec.aggregation or spec.fl.aggregation)
    adv_masks = spec.adversary_masks()
    k_n, s_n, r_n = len(lowered), len(spec.strategies), len(spec.seeds)
    t_n = spec.num_rounds
    acc = np.zeros((k_n, s_n, r_n, t_n), np.float32)
    loss = np.zeros_like(acc)
    nsel = np.zeros_like(acc)
    if agg.clustered:
        c_acc = np.zeros((k_n, s_n, r_n, t_n, agg.n_clusters), np.float32)
        c_loss = np.zeros_like(c_acc)
        c_assign = np.zeros((k_n, s_n, r_n, t_n, spec.fl.num_clients),
                            np.int32)
    tel: Dict[str, np.ndarray] = {}
    compile_s = 0.0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for k, low in enumerate(lowered):
        for r, seed in enumerate(spec.seeds):
            plan = low.composed_plan(r)
            for s, strat in enumerate(spec.strategies):
                h = run_fl_host(plan, spec.fl, strategy=strat,
                                aggregation=spec.aggregation,
                                rounds=spec.rounds, ds=ds, seed=seed,
                                eval_n_per_class=spec.eval_n_per_class,
                                workload=spec.workload,
                                telemetry=spec.telemetry,
                                adversary=spec.adversary or None,
                                adv=None if adv_masks is None
                                else adv_masks[r], device=device)
                compile_s += h.compile_s
                acc[k, s, r] = h.accuracy
                loss[k, s, r] = h.loss
                nsel[k, s, r] = h.num_selected
                if agg.clustered:
                    c_acc[k, s, r] = h.cluster_accuracy
                    c_loss[k, s, r] = h.cluster_loss
                    c_assign[k, s, r] = h.cluster_assign
                for name, v in (h.telemetry or {}).items():
                    v = np.asarray(v, np.float32)
                    if name not in tel:
                        tel[name] = np.zeros((k_n, s_n, r_n) + v.shape,
                                             np.float32)
                    tel[name][k, s, r] = v
    wall = time.perf_counter() - t0 - compile_s
    record_memory_analysis("host:grid", device)
    meta: Dict[str, Any] = {}
    if agg.clustered:
        meta.update(_clustered_meta(c_acc, c_loss, c_assign))
    if tel:
        meta["_telemetry_series"] = tel
    return acc, loss, nsel, wall, compile_s, meta


def _engine_hier(spec: ExperimentSpec, lowered: Sequence[LoweredScenario],
                 ds, device):
    """Hierarchical two-tier rounds (``fl.population``)."""
    from .population import run_engine_hier
    return run_engine_hier(spec, lowered, ds, device)


def _engine_async(spec: ExperimentSpec, lowered: Sequence[LoweredScenario],
                  ds, device):
    """Async FedBuff windows (``fl.population``)."""
    from .population import run_engine_async
    return run_engine_async(spec, lowered, ds, device)


def _sharded_group(n_clients: int):
    """-> (group, groups, rank, world): without an initialised default
    process group one group and no communication; with one, the largest
    divisor of N not above the world size (the reference's rule on its
    device count), the ranks past it outside the rounds."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None, 1, 0, 1
    world, rank = dist.get_world_size(), dist.get_rank()
    groups = max(g for g in range(1, world + 1) if n_clients % g == 0)
    group = (dist.group.WORLD if groups == world
             else dist.new_group(list(range(groups))))
    return group, groups, rank, world


def _engine_sharded(spec: ExperimentSpec, lowered: Sequence[LoweredScenario],
                    ds, device):
    """The gather-based round over a ``torch.distributed`` process group
    (``fl.sharded``): each rank draws only its block of each round's rows,
    selection runs on the all-gathered histograms on every rank, only the
    ``order[:budget]`` slots train, and the weighted delta mean (or the
    gather-reduce of a robust family) is all-reduced back.

    Every strategy and every aggregation family of the registries runs
    (each strategy its own round with its own static budget), with the
    spec's adversary and telemetry.  Without an initialised default process
    group the engine runs one group on ``device``; with one, every rank
    calls ``run`` with the same spec, the round runs on the first
    ``groups`` ranks (the largest divisor of N not above the world size)
    and every rank returns the same result.  ``REPRO_SHARDED_EXCHANGE``
    picks ``a2a`` (default) or ``allgather``, two bit-identical exchanges;
    ``meta["sharded"]`` holds the reference's facts."""
    import os
    from collections import deque

    import torch.distributed as dist
    from .. import rng
    from ..data import client_batches
    from ..optim import get_optimizer
    from .client import batched_eval, local_gradient, local_train
    from .loop import RoundTelemetry, cluster_mixture
    from .round import resolve_adversary, stack_global_params
    from .sharded import exchange_bytes_per_device, make_sharded_fl_round
    from .workloads import get_workload

    cfg = spec.fl
    agg = get_aggregator(spec.aggregation or cfg.aggregation)
    poison_scale, tau = resolve_adversary(spec.adversary)
    attacked = poison_scale is not None or tau > 0
    adv_masks = spec.adversary_masks() if attacked else None
    n_clients = cfg.num_clients
    group, groups, rank, world = _sharded_group(n_clients)
    per_group = n_clients // groups
    exchange = os.environ.get("REPRO_SHARDED_EXCHANGE", "a2a")
    k_n, s_n, r_n = len(lowered), len(spec.strategies), len(spec.seeds)
    t_n = spec.num_rounds
    acc = np.zeros((k_n, s_n, r_n, t_n), np.float32)
    loss = np.zeros_like(acc)
    nsel = np.zeros_like(acc)
    c_acc = c_loss = c_assign = None
    if agg.clustered:
        c_acc = np.zeros((k_n, s_n, r_n, t_n, agg.n_clusters), np.float32)
        c_loss = np.zeros_like(c_acc)
        c_assign = np.zeros((k_n, s_n, r_n, t_n, n_clients), np.int32)
    tel: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if rank < groups:
        wl = get_workload(spec.workload)
        opt = get_optimizer(cfg.optimizer, cfg.lr)
        eval_batch = wl.eval_set(ds, spec.eval_n_per_class)
        eval_fn = wl.make_eval(ds)
        if agg.clustered:
            eval_fn = batched_eval(eval_fn)
        loss_fn = wl.make_loss(ds)
        if agg.base == "fedavg":
            server_lr = cfg.server_lr

            def local_step(params, batch):      # leaves (S, ...)
                return local_train(params, opt, batch, loss_fn,
                                   cfg.local_epochs)[0]
        else:
            server_lr = 1.0                     # fedsgd: no interpolation

            def local_step(params, batch):
                # The client delta −lr·∇ makes the weighted delta mean the
                # engines' aggregate-gradients-then-step FedSGD update.
                g, _ = local_gradient(params, batch, loss_fn)
                return {k: p - cfg.lr * g[k] for k, p in params.items()}

        round_fns = {strat: make_sharded_fl_round(
            group, local_step, n_select=cfg.clients_per_round,
            num_classes=wl.num_classes(ds), num_clients=n_clients,
            strategy=strat, server_lr=server_lr, exchange=exchange,
            n_clusters=agg.n_clusters, kmeans_iters=agg.kmeans_iters,
            reduce_fn=agg.reduce, poison_scale=poison_scale,
            with_stale=tau > 0) for strat in spec.strategies}
        keys = ["hists", "mask", "num_classes", "params_old", "params_new"]
        if agg.clustered:
            keys += ["assign", "n_clusters", "centroids", "prev_centroids"]
        rows = torch.arange(rank * per_group, (rank + 1) * per_group,
                            device=device)

        def draw(plan_t: np.ndarray, kt):
            """This rank's block of the round: its rows of the whole
            population's draw (``Workload.sample``'s row offsets) -> the
            block's batches, labels and valid flags."""
            labels_all = torch.as_tensor(plan_t, dtype=torch.int32,
                                         device=device)
            labels = labels_all[rows]
            block = {**wl.sample(ds, rng.fold_in(kt, 0), labels_all, rows),
                     "labels": labels, "valid": labels >= 0}
            return (client_batches(block, cfg.batch_size, wl.batch_keys),
                    labels, block["valid"])

        def evaluate(p: Dict[str, torch.Tensor], info):
            """-> (accuracy, loss) of the global model, a clustered
            family's mixture over its models, then the per-cluster
            accuracies and losses (None for one model)."""
            with torch.no_grad():
                l_, m = eval_fn(p, eval_batch)
            if not agg.clustered:
                return float(m["accuracy"]), float(l_), None, None
            w = info["cluster_weights"]
            return (float(cluster_mixture(m["accuracy"], w)),
                    float(cluster_mixture(l_, w)),
                    m["accuracy"].cpu().numpy(), l_.cpu().numpy())

        xbytes: Optional[Dict[str, int]] = None
        for k, low in enumerate(lowered):
            for r, seed in enumerate(spec.seeds):
                plan = low.composed_plan(r)
                key = rng.PRNGKey(int(seed), device)
                init = wl.init(rng.fold_in(key, 1), ds)
                if agg.clustered:
                    init = stack_global_params(init, agg.n_clusters)
                params = {strat: init for strat in spec.strategies}
                tels = {strat: RoundTelemetry(spec.telemetry, agg, keys)
                        for strat in spec.strategies}
                extra = ()
                if attacked:
                    extra = (torch.as_tensor(adv_masks[r], device=device,
                                             dtype=torch.float32),)
                # stale_update window: past[strat][0] is θ_{t−τ} (θ₀ early).
                past = ({strat: deque([init], maxlen=tau + 1)
                         for strat in spec.strategies} if tau else None)
                for t in range(t_n):
                    # A round's data and keys depend on (scenario, seed,
                    # round) alone: drawn once for every strategy.
                    with span("sharded:round", round=t):
                        kt = rng.fold_in(key, 1000 + t)
                        batches, labels, valid = draw(
                            plan[t % plan.shape[0]], kt)
                        if xbytes is None:
                            xbytes = {st: exchange_bytes_per_device(
                                batches, n_clients, fn.budget_padded, groups,
                                exchange) for st, fn in round_fns.items()
                                if fn.exchange is not None}
                        for s, strat in enumerate(spec.strategies):
                            old = params[strat]
                            stale = (past[strat][0],) if tau else ()
                            params[strat], info = round_fns[strat](
                                old, batches, labels, valid,
                                rng.fold_in(kt, 1), *extra, *stale)
                            if tau:
                                past[strat].append(params[strat])
                            if tels[strat].metrics:
                                cl = ({"assign": info["cluster_assign"][None],
                                       "centroids":
                                           info["cluster_centroids"][None]}
                                      if agg.clustered else {})
                                tels[strat].add(
                                    info["hists"][None], info["mask"][None],
                                    {n: p[None] for n, p in old.items()},
                                    {n: p[None]
                                     for n, p in params[strat].items()}, **cl)
                            cell = (k, s, r, t)
                            acc[cell], loss[cell], ca, cl_ = evaluate(
                                params[strat], info)
                            nsel[cell] = float(info["num_selected"])
                            if agg.clustered:
                                c_acc[cell], c_loss[cell] = ca, cl_
                                c_assign[cell] = info[
                                    "cluster_assign"].cpu().numpy()
                for s, strat in enumerate(spec.strategies):
                    for name, v in (tels[strat].result() or {}).items():
                        if name not in tel:
                            tel[name] = np.zeros((k_n, s_n, r_n)
                                                 + v.shape[1:], np.float32)
                        tel[name][k, s, r] = v[0]
        meta["sharded"] = {
            "groups": groups, "clients": n_clients,
            "clients_per_group": per_group, "exchange": exchange,
            "n_clusters": agg.n_clusters,
            "reduce": "gather" if agg.reduce is not None else "psum",
            "strategies": {
                strat: {"budget": fn.budget,
                        "trained_per_round": fn.trained_per_round,
                        "flop_sparsity": fn.flop_sparsity,
                        # Analytic ring bytes a rank receives in the
                        # exchange (None when no round ran).
                        "exchange_bytes_per_device":
                            None if xbytes is None else xbytes.get(strat)}
                for strat, fn in round_fns.items()}}
        if agg.clustered:
            meta.update(_clustered_meta(c_acc, c_loss, c_assign))
        if tel:
            meta["_telemetry_series"] = tel
    wall = time.perf_counter() - t0
    record_memory_analysis("sharded:grid", device)
    out = [acc, loss, nsel, wall, 0.0, meta]
    if world > 1:
        # Every rank returns rank 0's result, the ranks past ``groups``
        # included.
        dist.broadcast_object_list(out, src=0)
    return tuple(out)


register_engine("sim", _engine_sim, option_keys=())
register_engine("host", _engine_host, option_keys=())
register_engine("sharded", _engine_sharded, option_keys=())
register_engine("hier", _engine_hier, option_keys=("num_blocks",))
register_engine("async", _engine_async,
                option_keys=("num_blocks", "buffer_k", "alpha", "tau_max"))


# ---------------------------------------------------------------------------
# The one run surface
# ---------------------------------------------------------------------------

def run(spec: ExperimentSpec, *, ds=None,
        device: "str | torch.device | None" = None) -> ExperimentResult:
    """Execute a declarative experiment spec on ``device`` (None means
    ``"cuda"``) and return the labeled result.

    Validates the spec, lowers every ScenarioSpec (source + ordered
    transforms) to arrays once, dispatches through the engine registry and
    labels the output axes (scenario, strategy, seed, round).  Each stage
    runs under an ``obs`` span, the engine under ``obs.profiler`` (and
    ``torch.profiler`` with ``REPRO_TRACE_DIR`` set).  ``meta["telemetry"]``
    is the reference's versioned envelope: the metric series, the engines'
    side facts (``meta["clustered"]`` and the grid engine's ``meta["sim"]``
    stay as aliases), the span summary and the run's peak device memory."""
    with span("validate", engine=spec.engine):
        spec.validate()
    device = resolve_device(device)
    if ds is None:
        from .workloads import get_workload
        ds = get_workload(spec.workload).make_dataset(device)
    with span("lower_scenarios", engine=spec.engine):
        lowered = [s.lower(spec.fl, spec.seeds, spec.num_rounds)
                   for s in spec.scenarios]
    n_mem = len(memory_snapshots())
    with profiler(spec.engine):
        out = _ENGINES[spec.engine](spec, lowered, ds, device)
    acc, loss, nsel, wall_s, compile_s = out[:5]
    meta = dict(out[5]) if len(out) > 5 else {}
    record_duration(f"engine_compile:{spec.engine}", compile_s)
    record_duration(f"engine_wall:{spec.engine}", wall_s)
    series = meta.pop("_telemetry_series", None)
    facts = {k: meta[k] for k in ("sharded", "population", "clustered", "sim")
             if k in meta}
    meta["telemetry"] = build_envelope(
        spec.engine, series=series, engine_facts=facts or None,
        spans=span_summary(),
        memory_analysis=memory_snapshots()[n_mem:] or None)
    write_trace()          # nothing unless REPRO_TRACE_DIR is set
    return ExperimentResult(
        scenarios=tuple(s.name for s in spec.scenarios),
        strategies=tuple(spec.strategies), seeds=tuple(spec.seeds),
        accuracy=np.asarray(acc), loss=np.asarray(loss),
        num_selected=np.asarray(nsel), engine=spec.engine,
        wall_s=wall_s, compile_s=compile_s, meta=meta)


# ---------------------------------------------------------------------------
# A beyond-paper strategy registered purely through the public API, as the
# reference registers it (strategy id 8).
# ---------------------------------------------------------------------------

def select_dirichlet_uniformity(key, hists: torch.Tensor,
                                n_select: int) -> SelectionResult:
    """Dirichlet-posterior expected entropy of p(L_i): with α = h + 1,
    ``Σ_c (α_c/α₀)(ψ(α₀+1) − ψ(α_c+1))``, sample-size aware where the
    plug-in ``entropy``/``kl`` scores are not.  ψ and the class sums round
    as the reference's compiled CPU code does (``core.ordered``), so orders
    are bit-equal to the reference's."""
    del key
    alpha = hists.to(torch.float32) + 1.0
    a0 = class_sum(alpha)[..., None]
    scores = class_dot(alpha / a0, digamma(a0 + 1.0) - digamma(alpha + 1.0))
    valid = class_sum(hists) > 0
    mask, order = topn_mask(scores, valid, n_select)
    return SelectionResult(mask, scores, order)


if "dirichlet_uniformity" not in STRATEGIES:
    register_strategy("dirichlet_uniformity", select_dirichlet_uniformity)
