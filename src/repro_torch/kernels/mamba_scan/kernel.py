"""The Mamba-1 selective scan on the card: wrapper of the CUDA kernel
``mamba_scan`` (``csrc/mamba_scan.cu``, which states its design and
bound).  It replaces the JAX package's
``kernels/mamba_scan/kernel.py::mamba_scan_pallas``.

The wrapper validates the six inputs (one CUDA device, float32,
contiguous, consistent shapes, N of 8 or 16), allocates y and the last
state, launches on the current stream and raises on a launch error.
Unlike the TPU kernel it takes any S >= 1 and any D.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
KERNELS = ("mamba_scan",)
STATE_SIZES = (8, 16)      # the kernel's template instances
MAX_BATCH = 65535          # the grid's y extent

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def _bind(lib) -> None:
    lib.mamba_scan.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                               _LL, _LL, _LL, ctypes.c_int, _P]
    lib.mamba_scan.restype = ctypes.c_int


LIB = _build.Library("mamba_scan", SOURCE, _bind, KERNELS)


def launches() -> dict:
    return _build.launches(KERNELS)


def reset_launches() -> None:
    _build.reset_launches(KERNELS)


def mamba_scan_cuda(x, delta, b, c, a, h0):
    """Launch the kernel; returns (y (B,S,D), last (B,D,N))."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"mamba_scan runs on CUDA tensors, got {dev}")
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"x must be (B,S,D) and a (D,N), got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    bsz, s, d = x.shape
    n = a.shape[1]
    shapes = {"x": (bsz, s, d), "delta": (bsz, s, d), "b": (bsz, s, n),
              "c": (bsz, s, n), "a": (d, n), "h0": (bsz, d, n)}
    for name, t in zip(shapes, (x, delta, b, c, a, h0)):
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; mamba_scan "
                            f"takes float32 on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan takes N in {STATE_SIZES}, got {n}")
    if bsz > MAX_BATCH:
        raise ValueError(f"mamba_scan takes at most {MAX_BATCH} rows, "
                         f"got {bsz}")
    y = torch.empty_like(x)
    last = torch.empty_like(h0)
    if bsz == 0 or d == 0:
        return y, last
    lib = LIB.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mamba_scan(x.data_ptr(), delta.data_ptr(), b.data_ptr(),
                            c.data_ptr(), a.data_ptr(), h0.data_ptr(),
                            y.data_ptr(), last.data_ptr(), bsz, s, d, n,
                            stream)
    _build.check(rc, "mamba_scan")
    _build.count("mamba_scan")
    return y, last
