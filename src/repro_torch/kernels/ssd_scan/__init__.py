from .ops import SSDScan, SSDScanBackward, ssd_apply
from .ref import ssd_apply_ref, ssd_chunked_ref, ssd_ref
from .ssd_scan import ssd_scan

__all__ = ["SSDScan", "SSDScanBackward", "ssd_apply", "ssd_apply_ref",
           "ssd_chunked_ref", "ssd_ref", "ssd_scan"]
