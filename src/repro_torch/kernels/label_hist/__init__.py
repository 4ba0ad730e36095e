from .label_hist import label_hist_kernel
from .ref import label_hist_ref

__all__ = ["label_hist_kernel", "label_hist_ref"]
