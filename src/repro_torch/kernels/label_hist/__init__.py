from .label_hist import label_hist_kernel
from .ops import client_statistics
from .ref import label_hist_ref

__all__ = ["client_statistics", "label_hist_kernel", "label_hist_ref"]
