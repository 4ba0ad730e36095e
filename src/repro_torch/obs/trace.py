"""Host-side trace spans, the profiler hook and memory snapshots (mirrors
``repro.obs.trace``).

A *span* times one host-side stage (``validate``, ``lower_scenarios``, an
engine's execution).  Events accumulate in a process-global buffer in
Chrome ``trace_event`` form (complete ``"ph": "X"`` events, microsecond
timestamps), so :func:`write_trace` output loads into Perfetto or
``chrome://tracing``.  Engine ``compile_s``/``wall_s`` fold into the same
stream.

``REPRO_TRACE_DIR=<dir>`` switches on the heavy hooks: an engine's execution
runs under ``torch.profiler`` (CPU, and CUDA when a card is present; its
Chrome trace is written to ``<dir>/torch/``, the grid engine's
``grid/<phase>`` ranges included) and the span file goes to
``<dir>/trace_<pid>.json``.  The reference profiles with ``jax.profiler``
instead and snapshots its compiled modules' memory; the port compiles
nothing ahead and records each engine run's peak device memory
(:func:`record_memory_analysis`).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

ENV_TRACE_DIR = "REPRO_TRACE_DIR"

_LOCK = threading.Lock()
_EVENTS: List[Dict[str, Any]] = []
_MEMORY: List[Dict[str, Any]] = []
# trace_event timestamps are µs from one epoch a process.
_T0 = time.perf_counter()


def trace_dir() -> Optional[str]:
    """The configured trace directory, or None when tracing is off."""
    d = os.environ.get(ENV_TRACE_DIR, "").strip()
    return d or None


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


def _append(ev: Dict[str, Any], args: Dict[str, Any]) -> None:
    if args:
        ev["args"] = dict(args)
    with _LOCK:
        _EVENTS.append(ev)


class Span:
    """Handle yielded by :func:`span`; ``duration_s`` is valid after exit."""

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        self.start_us = _now_us()
        self.duration_s = 0.0

    def close(self) -> None:
        end = _now_us()
        self.duration_s = (end - self.start_us) / 1e6
        _append({"name": self.name, "ph": "X", "ts": self.start_us,
                 "dur": end - self.start_us, "pid": os.getpid(),
                 "tid": threading.get_ident()}, self.args)


@contextlib.contextmanager
def span(name: str, **args: Any):
    """Time a host-side stage: ``with span("validate", engine="sim"): …``;
    records one complete event on exit (also on an exception)."""
    s = Span(name, args)
    try:
        yield s
    finally:
        s.close()


def instant(name: str, **args: Any) -> None:
    """Record a zero-duration marker event."""
    _append({"name": name, "ph": "i", "ts": _now_us(), "s": "p",
             "pid": os.getpid(), "tid": threading.get_ident()}, args)


def record_duration(name: str, seconds: float, **args: Any) -> None:
    """Fold a duration measured elsewhere (an engine's ``compile_s`` or
    ``wall_s``) into the stream as a complete event ending now."""
    dur_us = max(float(seconds), 0.0) * 1e6
    _append({"name": name, "ph": "X", "ts": _now_us() - dur_us,
             "dur": dur_us, "pid": os.getpid(),
             "tid": threading.get_ident()}, args)


def events() -> List[Dict[str, Any]]:
    """Snapshot of the accumulated trace events."""
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def reset() -> None:
    """Clear the buffered events and memory snapshots (tests)."""
    with _LOCK:
        _EVENTS.clear()
        _MEMORY.clear()


def span_summary() -> Dict[str, Dict[str, float]]:
    """name -> {count, total_s} over the complete events so far."""
    out: Dict[str, Dict[str, float]] = {}
    for ev in events():
        if ev.get("ph") != "X":
            continue
        agg = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += ev.get("dur", 0.0) / 1e6
    return out


def write_trace(path: Optional[str] = None) -> Optional[str]:
    """Write the buffered events as a Chrome trace file: ``path``, or
    ``$REPRO_TRACE_DIR/trace_<pid>.json`` (nothing when that is unset)."""
    if path is None:
        d = trace_dir()
        if d is None:
            return None
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace_{os.getpid()}.json")
    else:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events(), "displayTimeUnit": "ms"}, f)
    return path


@contextlib.contextmanager
def profiler(label: str):
    """An engine's execution under a span and, with ``REPRO_TRACE_DIR`` set,
    under ``torch.profiler``, whose Chrome trace is written to
    ``<dir>/torch/<label>_<pid>.json`` on exit."""
    d = trace_dir()
    with span(f"engine_execute:{label}"):
        if d is None:
            yield
            return
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out = os.path.join(d, "torch")
        os.makedirs(out, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(
            os.path.join(out, f"{label}_{os.getpid()}.json"))


def record_memory_analysis(label: str, device) -> None:
    """Snapshot the peak device memory of a run on a CUDA ``device``
    (``torch.cuda.max_memory_allocated`` since the engine reset it) under
    ``label``; a CPU run records nothing."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return
    snap = {"label": label,
            "peak_bytes_allocated": int(torch.cuda.max_memory_allocated(
                device))}
    with _LOCK:
        _MEMORY.append(snap)


def memory_snapshots() -> List[Dict[str, Any]]:
    with _LOCK:
        return [dict(m) for m in _MEMORY]
