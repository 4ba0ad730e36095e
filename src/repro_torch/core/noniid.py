"""The paper's six non-IID scenarios (§III-A) and the experiment partitioners,
as NumPy label plans.

A copy of the plan generators of ``repro.core.noniid`` (NumPy only, so plans
are bit-equal to the reference's for the same arguments).  For each global
round T and client i a plan gives the client's training-label multiset:
int32 array (T, N, max_n), entries -1 are ragged-size padding.  The
scenario transforms (availability, quantity skew, adversary masks and label
flips) are copies too: the same NumPy draws give the same plans and masks.
"""
from __future__ import annotations

import numpy as np

CASES = ("iid", "case1a", "case1b", "case2a", "case2b", "case3a", "case3b")

# Paper §III-B experimental constants.
SAMPLES_PER_CLIENT = 290
MAJORITY_PER_CLIENT = 200
MINORITY_PER_CLIENT = 90


def _minority_fill(rng: np.random.Generator, major: np.ndarray, num_classes: int,
                   count: int) -> np.ndarray:
    """Uniform labels over ℒ \\ {major} (the paper's ℓ̃_j; shape (..., count))."""
    draw = rng.integers(0, num_classes - 1, size=major.shape + (count,))
    return np.where(draw >= major[..., None], draw + 1, draw).astype(np.int32)


def case_label_plan(case: str, seed: int, num_rounds: int, num_clients: int,
                    num_classes: int = 10,
                    samples_per_client: int = SAMPLES_PER_CLIENT,
                    majority: int = MAJORITY_PER_CLIENT) -> np.ndarray:
    """(T, N, n) int32 label plan for one of the seven §III cases."""
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; have {CASES}")
    rng = np.random.default_rng(seed)
    t, n, s = num_rounds, num_clients, samples_per_client
    if case == "iid":
        return rng.integers(0, num_classes, size=(t, n, s)).astype(np.int32)

    # Majority label per (round, client) according to the case's perspective.
    if case in ("case1a", "case1b"):
        major = rng.integers(0, num_classes, size=(t, n))
    elif case in ("case2a", "case2b"):
        seq = np.concatenate([rng.permutation(num_classes)
                              for _ in range(-(-t // num_classes))])[:t]
        major = np.repeat(seq[:, None], n, axis=1)
    else:  # case3a / case3b
        seq = rng.integers(0, num_classes, size=(t,))
        major = np.repeat(seq[:, None], n, axis=1)
    major = major.astype(np.int32)

    plan = np.repeat(major[..., None], s, axis=-1)
    if case.endswith("b"):
        minority_count = s - majority
        plan[..., majority:] = _minority_fill(rng, major, num_classes, minority_count)
    return plan


def bias_mix_plan(seed: int, num_clients: int, p_bias: float,
                  num_classes: int = 10, n_min: int = 30, n_max: int = 270,
                  num_rounds: int = 1) -> np.ndarray:
    """Figs. 6–7 partitioner: P(client fully biased) = p_bias; ragged n_i.

    Returns (T, N, n_max) with −1 padding; the plan is static across rounds
    (T=1 broadcastable) unless ``num_rounds`` > 1 is requested for re-draws.
    """
    rng = np.random.default_rng(seed)
    out = np.full((num_rounds, num_clients, n_max), -1, dtype=np.int32)
    for t in range(num_rounds):
        sizes = rng.integers(n_min, n_max + 1, size=num_clients)
        biased = rng.random(num_clients) < p_bias
        for i in range(num_clients):
            k = int(sizes[i])
            if biased[i]:
                out[t, i, :k] = rng.integers(0, num_classes)
            else:
                out[t, i, :k] = rng.integers(0, num_classes, size=k)
    return out


def dirichlet_plan(seed: int, num_clients: int, alpha: float,
                   num_classes: int = 10,
                   samples_per_client: int = SAMPLES_PER_CLIENT) -> np.ndarray:
    """Dirichlet(α) per-client class-mixture plan, (1, N, n) int32."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(num_classes, alpha), size=num_clients)
    out = np.empty((1, num_clients, samples_per_client), dtype=np.int32)
    for i in range(num_clients):
        out[0, i] = rng.choice(num_classes, size=samples_per_client, p=probs[i])
    return out


def plan_round(plan: np.ndarray, t: int) -> np.ndarray:
    """Labels for round t, handling static (T=1) plans."""
    return plan[t % plan.shape[0]]


# ---------------------------------------------------------------------------
# Composable scenario transforms
# ---------------------------------------------------------------------------

def availability_plan(seed: int, num_rounds: int, num_clients: int,
                      p_drop: float, min_available: int = 1) -> np.ndarray:
    """(T, N) bool availability mask: P(client i absent in round t) = p_drop.

    At least ``min_available`` clients stay available every round (an all-dark
    round has no defined FL semantics; real deployments retry)."""
    rng = np.random.default_rng(seed)
    avail = rng.random((num_rounds, num_clients)) >= p_drop
    for t in range(num_rounds):
        short = min_available - int(avail[t].sum())
        if short > 0:
            dark = np.flatnonzero(~avail[t])
            avail[t, rng.choice(dark, size=short, replace=False)] = True
    return avail


def apply_availability(plan: np.ndarray, avail: np.ndarray) -> np.ndarray:
    """Compose a label plan with a (T, N) availability mask.

    Unavailable clients' labels become −1 for the round: they report empty
    histograms (σ² undefined → invalid) so no strategy can select them, and
    their data is never materialized.

    Shape contract: plan (T_p, N, n), avail (T_a, N) with T_p == T_a or
    either equal to 1 (a static plan is tiled to the mask's horizon and vice
    versa)."""
    if plan.ndim != 3 or avail.ndim != 2:
        raise ValueError(f"need plan (T, N, n) and avail (T, N); got "
                         f"{plan.shape} and {avail.shape}")
    t_p, n, _ = plan.shape
    t_a, n_a = avail.shape
    if n_a != n or (t_p != t_a and 1 not in (t_p, t_a)):
        raise ValueError(f"plan {plan.shape} and avail {avail.shape} do not "
                         "compose: client counts must match and horizons "
                         "must be equal or broadcastable from 1")
    t = max(t_p, t_a)
    if t_p != t:
        plan = np.broadcast_to(plan, (t,) + plan.shape[1:])
    if t_a != t:
        avail = np.broadcast_to(avail, (t, n))
    return np.where(avail[..., None], plan, np.int32(-1)).astype(np.int32)


def adversary_mask(seed: int, num_clients: int, frac: float) -> np.ndarray:
    """(N,) float32 0/1 byzantine-client mask: ``round(frac·N)`` clients drawn
    without replacement are adversarial for the WHOLE run.

    Static across rounds (a compromised device stays compromised — the
    standard byzantine model, and what makes krum/trimmed-mean guarantees
    apply), deterministic from ``seed``.  The engines thread this exactly
    like the availability mask; ``frac=0`` is the all-honest identity."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"adversary frac must be in [0, 1]; got {frac}")
    rng = np.random.default_rng(seed)
    mask = np.zeros(num_clients, dtype=np.float32)
    n_adv = int(round(frac * num_clients))
    if n_adv:
        mask[rng.choice(num_clients, size=n_adv, replace=False)] = 1.0
    return mask


def flip_labels(plan: np.ndarray, adv: np.ndarray,
                num_classes: int = 10) -> np.ndarray:
    """Label-flip attack over a plan: adversarial clients' labels ℓ become
    C−1−ℓ (the standard inversion flip — classes map to their mirror, so the
    poisoned gradient points *against* the honest one instead of averaging
    out the way a uniform random relabel would).

    ``adv`` is the (N,) 0/1 mask from :func:`adversary_mask`; −1 ragged
    padding is untouched, honest clients pass through bit-identically."""
    if plan.ndim != 3 or adv.shape != (plan.shape[1],):
        raise ValueError(f"need plan (T, N, n) and adv (N,); got "
                         f"{plan.shape} and {adv.shape}")
    flip = (adv > 0)[None, :, None] & (plan >= 0)
    return np.where(flip, num_classes - 1 - plan, plan).astype(np.int32)


def quantity_skew(plan: np.ndarray, seed: int, n_min: int = 30,
                  n_max: int | None = None) -> np.ndarray:
    """Ragged per-client sample counts n_ti ~ U(n_min, n_max) over any plan.

    Each (round, client) keeps a uniform random *subsample* of its label
    multiset (preserving the case's mixture in expectation, unlike a prefix
    cut which would drop B-case minorities) and pads the tail with −1 — the
    padding stays contiguous.  Rows already shorter than the drawn n_ti keep
    their existing count, so −1 entries never resurrect."""
    t, n, s = plan.shape
    n_max = s if n_max is None else min(n_max, s)
    if not 0 < n_min <= n_max:
        raise ValueError(f"need 0 < n_min ≤ n_max ≤ {s}; got [{n_min}, {n_max}]")
    rng = np.random.default_rng(seed)
    # Shuffle each row's valid entries (padding sinks to the tail), then cut.
    keys = rng.random(plan.shape)
    keys[plan < 0] = 2.0
    order = np.argsort(keys, axis=-1)
    shuffled = np.take_along_axis(plan, order, axis=-1)
    sizes = rng.integers(n_min, n_max + 1, size=(t, n))
    keep = np.arange(s)[None, None, :] < sizes[..., None]
    return np.where(keep, shuffled, np.int32(-1)).astype(np.int32)
