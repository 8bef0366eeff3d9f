"""Sliding-window flash attention on the card: wrapper of the CUDA kernels
behind ``swa_attention`` (``csrc/swa_attention.cu``, which states their
design and bound).  It replaces the JAX package's ``kernels/swa_attention/
kernel.py::swa_attention_pallas``.

The inputs' type picks the kernel: bfloat16 takes the tensor-core kernel
(mma.sync on bf16 tiles, f32 accumulation, P rounded to bf16 before the
PV product as FlashAttention rounds it); float32 takes the CUDA-core
kernel, whose products stay in float32.  Both count as a launch of
``swa_attention``.  There is no fallback: a bfloat16 call launches the
tensor-core kernel or raises.

The wrapper validates q (B,S,H,hd) and k, v (B,S,K,hd): one CUDA device,
all float32 or all bfloat16, contiguous, K dividing H, hd at most 256,
window at least 1.  It allocates the output, launches on the current
stream and raises on a launch error.  Unlike the TPU kernel it takes any
S (the last tile is masked) and reads the GQA kv head in place.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "swa_attention.cu"
KERNELS = ("swa_attention",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GRID = 65535           # the grid's y (heads) and z (batch) extents

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def _bind(lib) -> None:
    lib.swa_attention.argtypes = [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL,
                                  _LL, ctypes.c_int, _P]
    lib.swa_attention.restype = ctypes.c_int


LIB = _build.Library("swa_attention", SOURCE, _bind, KERNELS)


def launches() -> dict:
    return _build.launches(KERNELS)


def reset_launches() -> None:
    _build.reset_launches(KERNELS)


def swa_attention_cuda(q, k, v, window: int):
    """Launch the kernel; returns the output (B,S,H,hd) in q's type."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"swa_attention runs on CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B,S,H,hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    bsz, s, h, hd = q.shape
    kh = k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"swa_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    shapes = {"q": (bsz, s, h, hd), "k": (bsz, s, kh, hd),
              "v": (bsz, s, kh, hd)}
    for name, t in zip(shapes, (q, k, v)):
        if t.device != dev or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; "
                            f"swa_attention takes {q.dtype} on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kh == 0 or h % kh:
        raise ValueError(f"kv heads {kh} must divide heads {h}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"swa_attention takes head_dim 1..{MAX_HEAD_DIM}, "
                         f"got {hd}")
    if window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if bsz > MAX_GRID or h > MAX_GRID:
        raise ValueError(f"swa_attention takes at most {MAX_GRID} rows and "
                         f"heads, got {bsz} and {h}")
    out = torch.empty_like(q)
    if bsz == 0 or s == 0 or h == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swa_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), bsz, s, h, kh, hd,
                               min(int(window), s), DTYPES[q.dtype], stream)
    _build.check(rc, "swa_attention")
    _build.count("swa_attention")
    return out
