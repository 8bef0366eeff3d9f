from .kernel import launches, reset_launches
from .ops import mamba_scan
from .ref import mamba_scan_ref

__all__ = ["launches", "mamba_scan", "mamba_scan_ref", "reset_launches"]
