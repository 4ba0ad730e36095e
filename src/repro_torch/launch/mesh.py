"""The card's constants for the roofline, and the reference's production
meshes as axis sizes.

The reference (``repro/launch/mesh.py``) builds JAX device meshes and states
a TPU v5e's peaks.  The port runs on NVIDIA H100 SXM cards (80 GB HBM3,
700 W), whose dense peaks from NVIDIA's data sheet take their place.

``make_debug_mesh`` builds the reference's debug mesh, every rank of the
initialised default process group (one card a rank, or one CPU process
under ``gloo``) on (``data``, ``model`` = 1), as a named
``torch.distributed`` ``DeviceMesh``: the mesh of the FSDP train step
(``launch.steps.make_train_step(..., mesh=...)``).  The 16×16 and 2×16×16
production meshes survive only as ``{axis: size}`` mappings, which the rule
tables of ``repro_torch.sharding`` read: the dry-run sizes its records
against them without a process group.
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


def make_debug_mesh(model: int = 1):
    """Every rank of the default process group on a (``data``, ``model``)
    ``DeviceMesh`` of (world // model, model), on the group's device type
    (``cuda`` under NCCL, else ``cpu``).  Tensor parallelism is not ported,
    so ``model`` must be 1."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism over a `model` axis is not "
            f"ported; the debug mesh takes model=1")
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs an initialised default "
                           "process group")
    world = dist.get_world_size()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=("data", "model"))


__all__ = ["HBM_BW", "HBM_BYTES", "NVLINK_BW", "ONE_CARD", "PEAK_FLOPS_BF16",
           "make_debug_mesh", "production_mesh"]
