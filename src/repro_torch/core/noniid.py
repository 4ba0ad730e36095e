"""The paper's six non-IID scenarios (§III-A) and the experiment partitioners,
as NumPy label plans.

A copy of the plan generators of ``repro.core.noniid`` (NumPy only, so plans
are bit-equal to the reference's for the same arguments).  For each global
round T and client i a plan gives the client's training-label multiset:
int32 array (T, N, max_n), entries -1 are ragged-size padding.  The
availability, quantity-skew and adversary transforms come with the
experiment slice of the port.
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
