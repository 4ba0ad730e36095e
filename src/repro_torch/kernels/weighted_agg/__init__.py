from .ref import weighted_agg_ref
from .weighted_agg import weighted_agg_kernel, weighted_agg_leaves

__all__ = ["weighted_agg_kernel", "weighted_agg_leaves", "weighted_agg_ref"]
