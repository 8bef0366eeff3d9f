"""Public wrapper of the Mamba-1 selective scan.

The CUDA kernel for CUDA tensors (or an error), the plain version for CPU
tensors: the device of the tensors picks, as for every kernel of the
port (the JAX package's ``kernel_dispatch`` switch and ``use_pallas``
flag have no counterpart).  On the card a call that needs a gradient
goes through ``_autograd.KernelFunction``: the kernel forward, the plain
version's gradient backward.
"""
from __future__ import annotations

from .. import _autograd
from .kernel import mamba_scan_cuda
from .ref import mamba_scan_ref


def mamba_scan(x, delta, b, c, a, h0):
    """x, delta: (B,S,D); b, c: (B,S,N); a: (D,N); h0: (B,D,N).  x, b
    and c float32 or bfloat16 (b and c may be column slices of one
    projection), the rest float32.  Returns (y (B,S,D) float32, h_last
    (B,D,N))."""
    if x.is_cuda:
        return _autograd.apply(mamba_scan_cuda, mamba_scan_ref,
                               (x, delta, b, c, a, h0))
    if x.device.type == "cpu":
        return mamba_scan_ref(x, delta, b, c, a, h0)
    raise ValueError(f"no mamba_scan for device {x.device}")
