"""The legacy DANA-Zero master round on the card: wrapper of the CUDA
kernel ``dana_master_update`` (``csrc/dana_update.cu``, which states its
design and bound).  It replaces the JAX package's
``kernels/dana_update/kernel.py::dana_master_update_2d``.

The wrapper validates the four inputs (one CUDA device, one dtype of
float32 or bfloat16, one shape, contiguous), forms the scalars in the
leaf's type (``ref.host_scalars``), allocates the four outputs, launches
on the current stream and raises on a launch error.  Out of place, like
the JAX kernel: the inputs are only read.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import DTYPES, host_scalars

SOURCE = Path(__file__).resolve().parent / "csrc" / "dana_update.cu"
KERNELS = ("dana_master_update",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p


def _bind(lib) -> None:
    lib.dana_master_update.argtypes = [
        ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, _P]
    lib.dana_master_update.restype = ctypes.c_int


LIB = _build.Library("dana_update", SOURCE, _bind, KERNELS)


def launches() -> dict:
    return _build.launches(KERNELS)


def reset_launches() -> None:
    _build.reset_launches(KERNELS)


def dana_master_update_cuda(theta, v_i, v0, g, lr, gamma):
    """Launch the kernel on one leaf; returns (theta', v_i', v0', hat)."""
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"dana_master_update runs on CUDA tensors, "
                         f"got {dev}")
    if theta.dtype not in DTYPES:
        raise TypeError(f"dana_master_update takes {DTYPES}, "
                        f"got {theta.dtype}")
    for name, x in (("v_i", v_i), ("v0", v0), ("g", g)):
        if x.device != dev or x.dtype != theta.dtype or x.shape != theta.shape:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}; theta is {theta.dtype} "
                             f"{tuple(theta.shape)} on {dev}")
    for name, x in (("theta", theta), ("v_i", v_i), ("v0", v0), ("g", g)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    outs = tuple(torch.empty_like(theta, memory_format=torch.contiguous_format)
                 for _ in range(4))
    n = theta.numel()
    if n == 0:
        return outs
    lr_h, gamma_h, lrg_h = host_scalars(lr, gamma, theta.dtype)
    lib = LIB.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dana_master_update(
            _DTYPE_CODE[theta.dtype], theta.data_ptr(), v_i.data_ptr(),
            v0.data_ptr(), g.data_ptr(), *(o.data_ptr() for o in outs), n,
            float(lr_h), float(gamma_h), float(lrg_h), stream)
    _build.check(rc, "dana_master_update")
    _build.count("dana_master_update")
    return outs
