"""PyTorch/CUDA port of the label-wise-clustering FL system (``repro``).

The package mirrors ``repro`` module for module and imports neither ``jax``
nor ``repro``.  Entry points take ``device=None``, which means ``"cuda"``;
without a card they raise unless the caller passes ``device="cpu"``.  The two
kernels of the FL round (label histograms and the weighted client sum) are
hand-written CUDA for Hopper under ``kernels/``.  Experiments run through
``fl.run(ExperimentSpec(...))``: the ``"sim"`` engine is the batched grid
(``fl/sim.py``, every trial of a grid in one round loop with one
``label_hist`` launch a round and one ``weighted_agg`` launch a round, or one
a cluster), ``"host"`` the per-trial loop ``fl.run_fl_host``.  Both run the
reference's clustered and robust aggregation families, its adversary
behaviors and its round telemetry (``obs``).  Randomness is JAX's threefry,
bit for bit (``rng``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
