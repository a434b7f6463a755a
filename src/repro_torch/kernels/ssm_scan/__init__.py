from .ops import selective_scan, ssm_scan
from .ref import ssm_scan_ref

__all__ = ["selective_scan", "ssm_scan", "ssm_scan_ref"]
