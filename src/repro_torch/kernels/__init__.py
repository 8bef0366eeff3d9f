"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``launches()`` / ``reset_launches()`` read and zero the launch counters
of every kernel whose package has been imported (``_build.LAUNCHES``);
each kernel package also exports its own pair over its kernels only.
"""
from ._build import launches, reset_launches

__all__ = ["launches", "reset_launches"]
