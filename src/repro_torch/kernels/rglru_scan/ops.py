"""Public wrapper of the RG-LRU scan.

The CUDA kernel for CUDA tensors (or an error), the plain version for CPU
tensors: the device of the tensors picks, as for every kernel of the
port (the JAX package's ``use_pallas`` flag has no counterpart).  On the
card a call that needs a gradient goes through
``_autograd.KernelFunction``: the kernel forward, the plain version's
gradient backward.
"""
from __future__ import annotations

from .. import _autograd
from .kernel import rglru_scan_cuda
from .ref import rglru_scan_ref


def rglru_scan(a, x, h0):
    """h_t = a_t * h_{t-1} + x_t over axis 1.  a, x: (B,S,D); h0: (B,D).
    Returns (h_all (B,S,D), h_last (B,D))."""
    if a.device.type == "cuda":
        return _autograd.apply(rglru_scan_cuda, rglru_scan_ref, (a, x, h0))
    if a.device.type == "cpu":
        return rglru_scan_ref(a, x, h0)
    raise ValueError(f"no rglru_scan for device {a.device}")
