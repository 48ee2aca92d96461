from .ops import selective_scan, selective_scan_bwd, selective_scan_fwd
from .ref import selective_scan_bwd_ref, selective_scan_ref

__all__ = ["selective_scan", "selective_scan_fwd", "selective_scan_bwd", "selective_scan_ref",
           "selective_scan_bwd_ref"]
