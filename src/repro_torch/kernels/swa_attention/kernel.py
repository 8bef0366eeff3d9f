"""Flash attention on the card: wrapper of the CUDA kernels behind
``swa_attention`` (``csrc/swa_attention.cu``, which states their design
and bound).  It replaces the JAX package's ``kernels/swa_attention/
kernel.py::swa_attention_pallas`` (causal, sliding window) and covers
the other cases of its model's jnp ``flash_attention``: non-causal
attention over keys of another length (the encoder and cross attention)
and segment masks (packed sequences).

The inputs' type picks the kernel: bfloat16 takes the tensor-core kernel
(mma.sync on bf16 tiles, f32 accumulation, P rounded to bf16 before the
PV product as FlashAttention rounds it); float32 takes the CUDA-core
kernel, whose products stay in float32.  Both count as a launch of
``swa_attention``.  There is no fallback: a bfloat16 call launches the
tensor-core kernel or raises.

The wrapper validates q (B,S,H,hd) and k, v (B,T,K,hd): one CUDA device,
all float32 or all bfloat16, contiguous, K dividing H, hd at most 256;
causal attention with T == S and a window at least 1 (None: every key up
to the query), or non-causal attention without a window; ``segments``
a contiguous int32 (B,S) tensor on q's device, with T <= S
(``ref.check_masks``).  It allocates the output, launches on the current
stream and raises on a launch error.  Unlike the TPU kernel it takes any
S and T (the last tiles are masked) and reads the GQA kv head in place.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import check_masks

SOURCE = Path(__file__).resolve().parent / "csrc" / "swa_attention.cu"
KERNELS = ("swa_attention",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GRID = 65535           # the grid's y (heads) and z (batch) extents

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def _bind(lib) -> None:
    lib.swa_attention.argtypes = [_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL,
                                  _LL, _LL, _LL, ctypes.c_int, ctypes.c_int,
                                  _P]
    lib.swa_attention.restype = ctypes.c_int


LIB = _build.Library("swa_attention", SOURCE, _bind, KERNELS)


def launches() -> dict:
    return _build.launches(KERNELS)


def reset_launches() -> None:
    _build.reset_launches(KERNELS)


def swa_attention_cuda(q, k, v, window=None, causal=True, segments=None):
    """Launch the kernel; returns the output (B,S,H,hd) in q's type."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"swa_attention runs on CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B,S,H,hd) and k (B,T,K,hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    bsz, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"swa_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    shapes = {"q": (bsz, s, h, hd), "k": (bsz, t, kh, hd),
              "v": (bsz, t, kh, hd)}
    for name, x in zip(shapes, (q, k, v)):
        if x.device != dev or x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype} on {x.device}; "
                            f"swa_attention takes {q.dtype} on {dev}")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shapes[name]}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kh == 0 or h % kh:
        raise ValueError(f"kv heads {kh} must divide heads {h}")
    if t == 0 and bsz * s * h:
        raise ValueError("swa_attention needs at least one key")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"swa_attention takes head_dim 1..{MAX_HEAD_DIM}, "
                         f"got {hd}")
    check_masks(q, k, window, causal, segments)
    if segments is not None and (segments.device != dev
                                 or segments.dtype != torch.int32
                                 or not segments.is_contiguous()):
        raise TypeError(f"segments must be a contiguous int32 tensor on "
                        f"{dev}, got {segments.dtype} on {segments.device}")
    if bsz > MAX_GRID or h > MAX_GRID:
        raise ValueError(f"swa_attention takes at most {MAX_GRID} rows and "
                         f"heads, got {bsz} and {h}")
    out = torch.empty_like(q)
    if bsz == 0 or s == 0 or h == 0:
        return out
    lib = LIB.load()
    window = s if window is None or not causal else min(int(window), s)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swa_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if segments is None else segments.data_ptr(), bsz, s, t, h,
            kh, hd, window, int(bool(causal)), DTYPES[q.dtype], stream)
    _build.check(rc, "swa_attention")
    _build.count("swa_attention")
    return out
