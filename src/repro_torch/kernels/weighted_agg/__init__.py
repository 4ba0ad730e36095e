from .ops import aggregate_params, normalized_scales
from .ref import weighted_agg_ref
from .weighted_agg import weighted_agg_kernel, weighted_agg_leaves

__all__ = ["aggregate_params", "normalized_scales", "weighted_agg_kernel",
           "weighted_agg_leaves", "weighted_agg_ref"]
