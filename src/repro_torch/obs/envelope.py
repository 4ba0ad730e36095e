"""The versioned telemetry envelope carried in ``ExperimentResult.meta``
(mirrors ``repro.obs.envelope``; the two packages read each other's)::

    meta["telemetry"] = {
        "version": 1,
        "engine": "sim",
        "axes": ["scenario", "strategy", "seed", "round"],
        "series": {name: {"axes": [...], "data": nested lists}, ...},
        "engine_facts": {...},           # the engines' side facts
        "spans": {"validate": {"count": 1, "total_s": 0.01}, ...},
        "memory_analysis": [{"label": "sim:grid",
                             "peak_bytes_allocated": ...}],
    }

``data`` holds nested lists of Python floats, so the JSON round trip is
exact.  The reference fills ``memory_analysis`` from its compiled modules;
the port compiles nothing ahead, so its entries are the peak device memory
of each engine run on a card (``torch.cuda.max_memory_allocated``, see
``trace.record_memory_analysis``), and the key is absent for a CPU run.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from .registry import BASE_AXES, get_metric

TELEMETRY_SCHEMA_VERSION = 1


def build_envelope(engine: str, *,
                   series: Optional[Mapping[str, np.ndarray]] = None,
                   engine_facts: Optional[Mapping[str, Any]] = None,
                   spans: Optional[Mapping[str, Any]] = None,
                   memory_analysis: Optional[Sequence[Mapping[str, Any]]] = None,
                   ) -> Dict[str, Any]:
    """The envelope from per-metric ``(K, S, R, rounds, …)`` arrays, values
    cast to float64 lists (float32 values survive the JSON round trip)."""
    env: Dict[str, Any] = {
        "version": TELEMETRY_SCHEMA_VERSION,
        "engine": engine,
        "axes": list(BASE_AXES),
        "series": {},
    }
    for name, arr in (series or {}).items():
        arr = np.asarray(arr)
        try:
            extra = get_metric(name).axes
        except KeyError:
            extra = tuple(f"dim{i}" for i in range(arr.ndim - len(BASE_AXES)))
        env["series"][name] = {
            "axes": list(BASE_AXES) + list(extra),
            "data": arr.astype(np.float64).tolist(),
        }
    if engine_facts:
        env["engine_facts"] = dict(engine_facts)
    if spans:
        env["spans"] = {k: dict(v) for k, v in dict(spans).items()}
    if memory_analysis:
        env["memory_analysis"] = [dict(m) for m in memory_analysis]
    return env


def series_arrays(envelope: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """name -> float64 array of an envelope's series."""
    return {name: np.asarray(s["data"], dtype=np.float64)
            for name, s in envelope.get("series", {}).items()}
