"""Launchers and tooling of the port: ``serve`` (prefill + decode loop),
``train`` (``run_train``), ``steps`` (the train, prefill and serve steps),
``dryrun`` (each step traced over fake tensors), ``roofline`` (its terms)
and ``mesh`` (the H100's constants and the debug mesh)."""
from .mesh import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS_BF16,
                   make_debug_mesh, production_mesh)

__all__ = ["HBM_BW", "HBM_BYTES", "NVLINK_BW", "PEAK_FLOPS_BF16",
           "make_debug_mesh", "production_mesh"]
