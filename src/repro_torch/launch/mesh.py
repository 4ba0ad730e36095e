"""The card's constants for the roofline, and the reference's production
meshes as axis sizes.

The reference (``repro/launch/mesh.py``) builds JAX device meshes and states
a TPU v5e's peaks.  The port runs on one NVIDIA H100 SXM (80 GB HBM3,
700 W), whose dense peaks from NVIDIA's data sheet take their place.  The
16×16 and 2×16×16 production meshes survive only as ``{axis: size}``
mappings, which the rule tables of ``repro_torch.sharding`` read; building a
256- or 512-rank mesh has no meaning on one card, so no device mesh is
built here (the multi-rank FL engine, ``fl/sharded.py``, takes its process
group from the caller).
"""
from __future__ import annotations

from typing import Dict

# H100 SXM (NVIDIA's data sheet, dense, 700 W): the bf16 tensor-core peak,
# HBM3 bandwidth and capacity, and NVLink 4's bandwidth each way (900 GB/s
# both ways together).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
HBM_BW = 3.35e12                # B/s
HBM_BYTES = 80e9                # B
NVLINK_BW = 450e9               # B/s, each way

# The mesh name of a one-card record.
ONE_CARD = "1xH100"


def production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as axis sizes: one pod of 16×16
    chips (``data``, ``model``), or two (``pod``, ``data``, ``model``)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


__all__ = ["HBM_BW", "HBM_BYTES", "NVLINK_BW", "ONE_CARD", "PEAK_FLOPS_BF16",
           "production_mesh"]
