from .kernel import launches, reset_launches
from .ops import rglru_scan
from .ref import rglru_scan_ref

__all__ = ["launches", "reset_launches", "rglru_scan", "rglru_scan_ref"]
