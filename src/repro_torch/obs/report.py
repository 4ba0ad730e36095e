"""Render a telemetry envelope as a per-round table + convergence-health
summary.

``python -m repro_torch.obs report <result.json>`` works on any
``ExperimentResult.to_json`` file (or a ``BENCH_*.json`` that embeds an
envelope) and always exits 0 — a result without telemetry still renders its
trajectories; reporting is diagnostic, not a gate.  The rendering and the
health flags are the reference's (``repro.obs.report``), line for line, so
both packages print the same text for the same envelope.
"""
from __future__ import annotations

import json
from typing import Any, List, Mapping, Optional

import numpy as np

from .envelope import series_arrays

# Health-flag thresholds (round-level heuristics, not acceptance gates).
ENTROPY_COLLAPSE_FRACTION = 0.5   # min round entropy < 0.5 * max → collapse
LOSS_DIVERGENCE_FACTOR = 2.0      # final loss > 2 * min loss → divergence
BYZANTINE_PERSISTENT_Z = 1.1      # |mean selected-round z| above → suspected
BYZANTINE_MIN_ROUNDS = 2          # ... over at least this many appearances


def _cell_series(arr: np.ndarray) -> np.ndarray:
    """Mean over the (scenario, strategy, seed) leading axes → one series
    per round (with any metric trailing axes preserved)."""
    arr = np.asarray(arr, dtype=np.float64)
    return arr.mean(axis=(0, 1, 2)) if arr.ndim >= 4 else arr


def health_flags(envelope: Mapping[str, Any],
                 loss: Optional[np.ndarray] = None) -> List[str]:
    """Convergence-health heuristics over an envelope's series.

    - ``selection-entropy collapse``: some round's mean entropy dropped
      below half the run's peak (selected label pdf concentrating).
    - ``cluster starvation``: a cluster whose occupancy is zero on every
      round — the "cluster 3 starved after round 12" failure mode.
    - ``loss divergence``: final mean loss more than 2x the run minimum.
    - ``suspected byzantine client``: some client's ``delta_outlier``
      z-score (as-reported update norm vs the round's selected-set
      mean/std) stays one-sided and large — |mean z over its selected
      rounds| > ``BYZANTINE_PERSISTENT_Z`` across ≥ ``BYZANTINE_MIN_ROUNDS``
      appearances.  Persistence is the fingerprint: with small cohorts any
      single round's max |z| saturates at √(n−1) even for honest outliers,
      but honest outliers rotate while a byzantine client is the SAME
      extreme every round.  Detects norm-visible attacks (poison with
      |scale| ≠ 1); a pure sign-flip preserves the norm and needs
      direction-aware detection.
    """
    flags: List[str] = []
    series = series_arrays(envelope)

    ent = series.get("selection_entropy")
    if ent is not None:
        e = _cell_series(ent)
        if e.size and e.max() > 0 and e.min() < ENTROPY_COLLAPSE_FRACTION * e.max():
            r = int(np.argmin(e))
            flags.append(
                f"selection-entropy collapse: round {r} mean entropy "
                f"{e.min():.3f} < {ENTROPY_COLLAPSE_FRACTION:.1f} x peak {e.max():.3f}")

    occ = series.get("cluster_occupancy")
    if occ is not None:
        o = _cell_series(occ)          # (rounds, M)
        if o.ndim == 2 and o.size:
            starved = np.flatnonzero((o == 0).all(axis=0))
            for m in starved:
                flags.append(f"cluster starvation: cluster {int(m)} has zero "
                             f"occupancy in every round")

    dz = series.get("delta_outlier")
    if dz is not None:
        z = np.asarray(dz, dtype=np.float64)
        if z.ndim >= 2 and z.size:
            zz = z.reshape((-1,) + z.shape[-2:])      # (cells, rounds, N)
            sel = np.abs(zz) > 1e-12                  # selected appearances
            cnt = sel.sum(axis=1)                     # (cells, N)
            persist = np.abs(zz.sum(axis=1)) / np.maximum(cnt, 1)
            persist = np.where(cnt >= BYZANTINE_MIN_ROUNDS, persist, 0.0)
            cells, clients = np.nonzero(persist > BYZANTINE_PERSISTENT_Z)
            if cells.size:
                worst = int(np.argmax(persist[cells, clients]))
                c, i = int(cells[worst]), int(clients[worst])
                flags.append(
                    f"suspected byzantine client: {cells.size} (cell, "
                    f"client) pair(s) with |mean selected-round "
                    f"delta_outlier z| > {BYZANTINE_PERSISTENT_Z:.2f} "
                    f"(worst: client {i}, {persist[c, i]:.2f}σ over "
                    f"{int(cnt[c, i])} round(s))")

    if loss is not None and loss.size:
        mean_loss = np.asarray(loss, dtype=np.float64)
        while mean_loss.ndim > 1:
            mean_loss = mean_loss.mean(axis=0)
        lo = mean_loss.min()
        if np.isfinite(lo) and lo > 0 and mean_loss[-1] > LOSS_DIVERGENCE_FACTOR * lo:
            flags.append(f"loss divergence: final mean loss {mean_loss[-1]:.4f} "
                         f"> {LOSS_DIVERGENCE_FACTOR:.1f} x best {lo:.4f}")
    return flags


def _fmt_value(v: np.ndarray) -> str:
    v = np.asarray(v)
    if v.ndim == 0:
        return f"{float(v):.4f}"
    flat = v.ravel()
    if flat.size <= 6:
        return "[" + " ".join(f"{float(x):.2f}" for x in flat) + "]"
    return (f"[{float(flat[0]):.2f} … {float(flat[-1]):.2f}] "
            f"(n={flat.size}, sum={float(flat.sum()):.2f})")


def render_report(doc: Mapping[str, Any]) -> str:
    """Pretty-print a result/bench JSON document's telemetry."""
    lines: List[str] = []
    meta = doc.get("meta", doc)
    env = meta.get("telemetry")
    name = doc.get("name") or doc.get("benchmark") or "result"
    lines.append(f"telemetry report — {name}")

    loss = None
    if "loss" in doc:
        loss = np.asarray(doc["loss"], dtype=np.float64)

    if not isinstance(env, Mapping) or not env.get("series"):
        lines.append("  no telemetry series recorded "
                     "(run with REPRO_TELEMETRY=1 or spec.telemetry)")
        if isinstance(env, Mapping) and env.get("spans"):
            lines.append("  spans:")
            for k, v in env["spans"].items():
                lines.append(f"    {k:<28} x{int(v.get('count', 0)):<3} "
                             f"{v.get('total_s', 0.0):8.3f}s")
        flags = health_flags(env if isinstance(env, Mapping) else {}, loss)
        lines.append(f"  health: {'; '.join(flags) if flags else 'OK'}")
        return "\n".join(lines)

    lines.append(f"  engine={env.get('engine', '?')} "
                 f"schema_version={env.get('version', '?')} "
                 f"axes={','.join(env.get('axes', []))}")
    series = series_arrays(env)
    rounds = max((_cell_series(a).shape[0] for a in series.values()
                  if _cell_series(a).ndim >= 1), default=0)

    names = sorted(series)
    lines.append("  per-round means over (scenario, strategy, seed):")
    header = "    round  " + "  ".join(f"{n[:22]:>22}" for n in names)
    lines.append(header)
    for r in range(rounds):
        row = [f"    {r:>5}  "]
        for n in names:
            s = _cell_series(series[n])
            row.append(f"{_fmt_value(s[r]) if r < s.shape[0] else '-':>22}  ")
        lines.append("".join(row).rstrip())

    if env.get("spans"):
        lines.append("  spans:")
        for k, v in env["spans"].items():
            lines.append(f"    {k:<28} x{int(v.get('count', 0)):<3} "
                         f"{v.get('total_s', 0.0):8.3f}s")
    if env.get("memory_analysis"):
        lines.append("  memory_analysis:")
        for m in env["memory_analysis"]:
            parts = [f"{k}={v}" for k, v in m.items() if k != "label"]
            lines.append(f"    {m.get('label', '?'):<24} {' '.join(parts)}")

    flags = health_flags(env, loss)
    if flags:
        lines.append("  health: FLAGS")
        for f in flags:
            lines.append(f"    ! {f}")
    else:
        lines.append("  health: OK")
    return "\n".join(lines)


def report_file(path: str) -> str:
    with open(path) as f:
        doc = json.load(f)
    return render_report(doc)
