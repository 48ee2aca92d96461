from .ops import selective_scan
from .ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref"]
