"""The RG-LRU scan on the card: wrapper of the CUDA kernel ``rglru_scan``
(``csrc/rglru_scan.cu``, which states its design and bound).  It
replaces the JAX package's ``kernels/rglru_scan/kernel.py::
rglru_scan_pallas``.

The wrapper validates the three inputs (one CUDA device, float32, as the
model passes them; contiguous; consistent shapes), allocates h_all and
the last state, launches on the current stream and raises on a launch
error.  Unlike the TPU kernel it takes any S >= 0 and any D.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
KERNELS = ("rglru_scan",)
MAX_BATCH = 65535          # the grid's y extent

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def _bind(lib) -> None:
    lib.rglru_scan.argtypes = [_P, _P, _P, _P, _P, _LL, _LL, _LL, _P]
    lib.rglru_scan.restype = ctypes.c_int


LIB = _build.Library("rglru_scan", SOURCE, _bind, KERNELS)


def launches() -> dict:
    return _build.launches(KERNELS)


def reset_launches() -> None:
    _build.reset_launches(KERNELS)


def rglru_scan_cuda(a, x, h0):
    """Launch the kernel; returns (h_all (B,S,D), last (B,D))."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA tensors, got {dev}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B,S,D), got {tuple(a.shape)}")
    bsz, s, d = a.shape
    shapes = {"a": (bsz, s, d), "x": (bsz, s, d), "h0": (bsz, d)}
    for name, t in zip(shapes, (a, x, h0)):
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; rglru_scan "
                            f"takes float32 on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bsz > MAX_BATCH:
        raise ValueError(f"rglru_scan takes at most {MAX_BATCH} rows, "
                         f"got {bsz}")
    out = torch.empty_like(a)
    last = torch.empty_like(h0)
    if bsz == 0 or d == 0:
        return out, last
    lib = LIB.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rglru_scan(a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                            out.data_ptr(), last.data_ptr(), bsz, s, d,
                            stream)
    _build.check(rc, "rglru_scan")
    _build.count("rglru_scan")
    return out, last
