from .ops import scan_layout, selective_scan, ssm_scan
from .ref import ssm_scan_ref

__all__ = ["scan_layout", "selective_scan", "ssm_scan", "ssm_scan_ref"]
