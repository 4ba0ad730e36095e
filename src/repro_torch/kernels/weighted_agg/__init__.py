from .ref import weighted_agg_ref
from .weighted_agg import weighted_agg_kernel

__all__ = ["weighted_agg_kernel", "weighted_agg_ref"]
