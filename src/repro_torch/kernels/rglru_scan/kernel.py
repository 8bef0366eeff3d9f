"""The RG-LRU scan on the card: wrapper of the CUDA kernel ``rglru_scan``
(``csrc/rglru_scan.cu``, which states its design and bound).  It
replaces the JAX package's ``kernels/rglru_scan/kernel.py::
rglru_scan_pallas``.

Lean launch path: the checks (one CUDA device, float32 as the model
passes them, consistent shapes, contiguity, at most ``MAX_BATCH`` rows)
run in one pass; h_all and the last state are allocated;
``_build.launch`` calls the kernel on the current stream with no device
context when the tensors lie on the current device; a launch error
raises.  The C entry point takes a decode step (S = 1) through its step
kernel and longer sequences through the staged scan.  Unlike the TPU
kernel it takes any S >= 0 and any D.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
KERNELS = ("rglru_scan",)
MAX_BATCH = 65535          # the scan grid's y extent

_F32 = torch.float32
_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def _bind(lib) -> None:
    lib.rglru_scan.argtypes = [_P, _P, _P, _P, _P, _LL, _LL, _LL,
                               ctypes.c_int, _P]
    lib.rglru_scan.restype = ctypes.c_int


LIB = _build.Library("rglru_scan", SOURCE, _bind, KERNELS)


def launches() -> dict:
    return _build.launches(KERNELS)


def reset_launches() -> None:
    _build.reset_launches(KERNELS)


def _scan_checks(a, x, h0):
    """One pass over the three inputs; returns (B, S, D) or raises."""
    if not a.is_cuda:
        raise ValueError(f"rglru_scan runs on CUDA tensors, got {a.device}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B,S,D), got {tuple(a.shape)}")
    bsz, s, d = a.shape
    idx = a.get_device()
    if not (x.get_device() == idx and h0.get_device() == idx
            and a.dtype is _F32 and x.dtype is _F32 and h0.dtype is _F32):
        raise TypeError(f"rglru_scan takes float32 a, x and h0 on "
                        f"{a.device}; got {x.dtype} on {x.device} and "
                        f"{h0.dtype} on {h0.device}")
    if x.shape != a.shape or h0.dim() != 2 or h0.shape[0] != bsz \
            or h0.shape[1] != d:
        raise ValueError(f"rglru_scan shapes: a {tuple(a.shape)}, x "
                         f"{tuple(x.shape)}, h0 {tuple(h0.shape)}; expected "
                         f"(B,S,D), (B,S,D), (B,D)")
    if not (a.is_contiguous() and x.is_contiguous() and h0.is_contiguous()):
        raise ValueError("rglru_scan takes a, x and h0 contiguous")
    if bsz > MAX_BATCH:
        raise ValueError(f"rglru_scan takes at most {MAX_BATCH} rows, "
                         f"got {bsz}")
    return bsz, s, d


def rglru_scan_cuda(a, x, h0):
    """Launch the kernel; returns (h_all (B,S,D), last (B,D))."""
    bsz, s, d = _scan_checks(a, x, h0)
    out = torch.empty_like(a)
    last = torch.empty_like(h0)
    if bsz == 0 or d == 0:
        return out, last
    vec = d % 4 == 0 and (a.data_ptr() | x.data_ptr() | h0.data_ptr()) \
        % 16 == 0               # out and last: fresh, so aligned
    rc = _build.launch(LIB.load().rglru_scan, a.get_device(), a.data_ptr(),
                       x.data_ptr(), h0.data_ptr(), out.data_ptr(),
                       last.data_ptr(), bsz, s, d, int(vec))
    if rc:
        _build.check(rc, "rglru_scan")
    _build.count("rglru_scan")
    return out, last
