from .ops import lru_scan, rglru_scan, scan_layout
from .ref import rglru_scan_ref

__all__ = ["lru_scan", "rglru_scan", "rglru_scan_ref", "scan_layout"]
