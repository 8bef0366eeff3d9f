"""The flat-update CUDA libraries, bound through the port's shared loader
(``kernels/_build.py``, which builds, loads and counts):

* ``csrc/flat_update.cu`` (``LIB``): ``flat_update_batch`` and
  ``send_view``;
* ``csrc/gap_update.cu`` (``GAP_LIB``): ``gap_update``, the gap-aware
  master update (ga-asgd).

``launches``/``reset_launches`` here cover the first library's kernels;
``kernels.launches()`` covers every library.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flat_update.cu"
KERNELS = ("flat_update_batch", "send_view")
GAP_SOURCE = Path(__file__).resolve().parent / "csrc" / "gap_update.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong


def _bind(lib) -> None:
    lib.flat_update_batch.argtypes = [
        _P, _P, _P, _P, _P,                       # theta, v, v0, u2, sent
        _P, _P, _P,                               # block, weights, pres
        _LL, _I, _I,                              # rows, n, k
        _I, _I, _I, _F, _I, _I,                   # flags, dc_lambda
        _F, _F, _F,                               # b2, 1 - b2, eps
        _P]                                       # stream
    lib.flat_update_batch.restype = _I
    lib.send_view.argtypes = [_P, _P, _P, _F, _P, _F, _P, _LL, _I, _LL,
                              _P]                 # ..., rows, n, pitch
    lib.send_view.restype = _I


def _bind_gap(lib) -> None:
    lib.gap_update_batch.argtypes = [
        _P, _P, _P, _P,                           # theta, v, sent, avg_step
        _P, _P,                                   # partials, pres
        _P, _P, _P, _P,                           # g/hat ptrs, ids, scalars
        _LL, _I, _I,                              # rows, n, k
        _F, _F, _F,                               # sqrt_p, ema, 1 - ema
        _P]                                       # stream
    lib.gap_update_batch.restype = _I


LIB = _build.Library("flat_update", SOURCE, _bind, KERNELS)
GAP_LIB = _build.Library("gap_update", GAP_SOURCE, _bind_gap,
                         ("gap_update",))
load = LIB.load
check = _build.check
count = _build.count
launch = _build.launch


def launches() -> dict:
    return _build.launches(KERNELS)


def reset_launches() -> None:
    _build.reset_launches(KERNELS)
