"""The Mamba-1 selective scan on the card: wrapper of the CUDA kernel
``mamba_scan`` (``csrc/mamba_scan.cu``, which states its state-parallel
design and its bounds).  It replaces the JAX package's
``kernels/mamba_scan/kernel.py::mamba_scan_pallas``.

The wrapper takes the inputs as ``apply_mamba`` makes them: x (the
convolved ``xc``) and B and C all float32 or all bfloat16, B and C as
column slices of one projection (last axis contiguous, the same other
strides); delta, A and h0 float32 and contiguous.  The kernel widens x,
B and C to float32 in registers, which is exact, so no cast or copy runs
before it.

Lean launch path: the checks (one CUDA device, dtypes, shapes,
contiguity, B's and C's strides, 16-byte alignment of A and h0, N of 8
or 16) run in one pass; y and the last state are allocated;
``_build.launch`` calls the kernel on the current stream with no device
context when the tensors lie on the current device; a launch error
raises.  Unlike the TPU kernel it takes any S >= 1 and any D.  A lane
carries two channels when B*D >= 32768 (``layout_for``), else one.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
KERNELS = ("mamba_scan",)
MAX_BATCH = 65535          # the grid's y extent
STATE_SIZES = (16, 8)
GROUP = 4                  # lanes a channel
# B*D from which a lane carries two channels (2,048 warps or more at
# (4, 2)): on an H100 (scripts/torch_host_cost.py) (4, 2) is the faster
# at falcon-mamba's prefill (B=4, D=8192) and (4, 1) at the Engine's
# one-request prefill (B=1)
TWO_CHANNELS_FROM = 32768

_F32, _BF16 = torch.float32, torch.bfloat16
_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def _bind(lib) -> None:
    lib.mamba_scan.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,   # tensors
                               _LL, _LL, _LL,                    # B S D
                               _LL, _LL,                         # strides
                               ctypes.c_int, _P]                 # flags
    lib.mamba_scan.restype = ctypes.c_int


LIB = _build.Library("mamba_scan", SOURCE, _bind, KERNELS)


def launches() -> dict:
    return _build.launches(KERNELS)


def reset_launches() -> None:
    _build.reset_launches(KERNELS)


def layout_for(bsz: int, d: int) -> tuple:
    """The chunked kernel's (lanes a channel, channels a lane) for a
    (B, ·, D) scan."""
    return GROUP, 2 if bsz * d >= TWO_CHANNELS_FROM else 1


def _scan_checks(x, delta, b, c, a, h0):
    """One pass over the six inputs; returns (B, S, D, N, B's strides)
    or raises."""
    if not x.is_cuda:
        raise ValueError(f"mamba_scan runs on CUDA tensors, got {x.device}")
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"x must be (B,S,D) and a (D,N), got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    shape = x.shape
    bsz, s, d = shape
    n = a.shape[1]
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan takes N in {STATE_SIZES}, got {n}")
    if bsz > MAX_BATCH:
        raise ValueError(f"mamba_scan takes at most {MAX_BATCH} rows, "
                         f"got {bsz}")
    idx = x.get_device()
    if not (delta.get_device() == idx and b.get_device() == idx
            and c.get_device() == idx and a.get_device() == idx
            and h0.get_device() == idx):
        raise TypeError(f"mamba_scan's inputs must all lie on {x.device}")
    if not ((x.dtype is _F32 or x.dtype is _BF16) and b.dtype is x.dtype
            and c.dtype is x.dtype and delta.dtype is _F32
            and a.dtype is _F32 and h0.dtype is _F32):
        raise TypeError(f"mamba_scan takes x, b, c all in float32 or all in "
                        f"bfloat16 and delta, a, h0 in float32; got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}, {delta.dtype}, "
                        f"{a.dtype}, {h0.dtype}")
    if delta.shape != shape or b.shape != c.shape or b.dim() != 3 \
            or b.shape[0] != bsz or b.shape[1] != s or b.shape[2] != n \
            or a.shape[0] != d or h0.dim() != 3 or h0.shape[0] != bsz \
            or h0.shape[1] != d or h0.shape[2] != n:
        raise ValueError(f"mamba_scan shapes: x {tuple(shape)}, delta "
                         f"{tuple(delta.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, a {tuple(a.shape)}, h0 "
                         f"{tuple(h0.shape)}; expected (B,S,D), (B,S,D), "
                         f"(B,S,N), (B,S,N), (D,N), (B,D,N)")
    if not (x.is_contiguous() and delta.is_contiguous() and a.is_contiguous()
            and h0.is_contiguous() and b.stride(2) == 1
            and c.stride(2) == 1):
        raise ValueError("mamba_scan takes x, delta, a and h0 contiguous "
                         "and b and c with a contiguous last axis")
    sb = b.stride()
    if c.stride() != sb:
        raise ValueError(f"mamba_scan takes b and c with the same strides, "
                         f"got {sb} and {c.stride()}")
    if (a.data_ptr() | h0.data_ptr()) % 16:
        raise ValueError("mamba_scan takes a and h0 16-byte aligned "
                         "(vector loads of the state)")
    return bsz, s, d, n, sb


def mamba_scan_cuda(x, delta, b, c, a, h0):
    """Launch the kernel; returns (y (B,S,D) float32, last (B,D,N))."""
    bsz, s, d, n, sb = _scan_checks(x, delta, b, c, a, h0)
    y = torch.empty_like(delta)
    last = torch.empty_like(h0)
    if bsz == 0 or d == 0:
        return y, last
    vec = d % 8 == 0 and (x.data_ptr() | delta.data_ptr()) % 16 == 0
    flags = ((x.dtype is _BF16) | vec << 1
             | (layout_for(bsz, d)[1] == 2) << 2 | n << 8)
    rc = _build.launch(LIB.load().mamba_scan, x.get_device(), x.data_ptr(),
                       delta.data_ptr(), b.data_ptr(), c.data_ptr(),
                       a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                       last.data_ptr(), bsz, s, d, sb[0], sb[1], flags)
    if rc:
        _build.check(rc, "mamba_scan")
    _build.count("mamba_scan")
    return y, last
