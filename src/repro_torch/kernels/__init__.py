"""Hand-written CUDA kernels for Hopper and the compute dispatch in front of
them.

Each kernel sits in its own package beside its plain PyTorch version
(``ref.py``); its wrapper launches the CUDA kernel for a CUDA tensor and takes
the plain version for a CPU tensor.  ``dispatch`` is what the FL round calls;
the LM layers call ``flash_attention.gqa_flash_attention`` and
``ssd_scan.ssd_apply``, both differentiable (``flash_attention_bwd`` and
``ssd_scan_bwd`` count the backwards' calls, one a call of their kernels).
Nothing here imports a compiler or builds a kernel until a CUDA tensor arrives
(``build.library``).  The package exports the reference's names
(``repro.kernels``), and the launch counts.
"""
from __future__ import annotations

import importlib

from .dispatch import (client_histograms, client_statistics, compute_backend,
                       masked_weighted_mean, weighted_sum_tree)
from .flash_attention import attention_ref, gqa_flash_attention
from .label_hist import label_hist as _label_hist
from .label_hist import label_hist_kernel, label_hist_ref
from .ssd_scan import ssd_apply, ssd_ref
from .weighted_agg import weighted_agg as _weighted_agg
from .weighted_agg import (aggregate_params, normalized_scales,
                           weighted_agg_kernel, weighted_agg_ref)

# The wrapper modules that count their kernel's launches (each package's
# __init__ re-exports a function of the module's own name, so import the
# module by path).
_MODULES = {
    "label_hist": _label_hist,
    "weighted_agg": _weighted_agg,
    "flash_attention": importlib.import_module(
        f"{__name__}.flash_attention.flash_attention"),
    "flash_attention_bwd": importlib.import_module(
        f"{__name__}.flash_attention.backward"),
    "ssd_scan": importlib.import_module(f"{__name__}.ssd_scan.ssd_scan"),
    "ssd_scan_bwd": importlib.import_module(f"{__name__}.ssd_scan.backward"),
}

# Two exported functions share their subpackage's name: bound last, they
# take the package attribute over the subpackage, as in the reference.
from .flash_attention import flash_attention  # noqa: E402
from .ssd_scan import ssd_scan  # noqa: E402

__all__ = ["aggregate_params", "attention_ref", "client_histograms",
           "client_statistics", "compute_backend", "flash_attention",
           "gqa_flash_attention", "label_hist_kernel", "label_hist_ref",
           "launch_counts", "masked_weighted_mean", "normalized_scales",
           "reset_launch_counts", "ssd_apply", "ssd_ref", "ssd_scan",
           "weighted_agg_kernel", "weighted_agg_ref", "weighted_sum_tree"]


def launch_counts() -> dict[str, int]:
    """CUDA launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
