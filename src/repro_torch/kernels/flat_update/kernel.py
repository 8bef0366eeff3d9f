"""The batched flat master update on the card: wrapper of the CUDA kernel
``flat_update_batch`` (``csrc/flat_update.cu``, which states its design
and bound).

It replaces both TPU lowerings of the JAX package's ``kernel.py``: the
full-slab ``flat_master_update_batch_2d`` and the scalar-prefetch
``flat_master_update_batch_prefetch``.  The TPU picked between them by
its VMEM budget; the CUDA kernel reads only the slab rows a batch names
and has no limit on the worker count, so there is one entry point and no
routing.

The wrapper validates every tensor (CUDA, float32, contiguous, shapes),
uploads the per-message scalars as ONE small (6, k) block, allocates the
outputs, launches on the current stream and raises on a launch error.
The state (theta, v, v0, u2, sent) is updated in place.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

HAT_MODES = {"theta": 0, "v0": 1, "self": 2, "weighted": 3}


def _check(name, x, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x):
    return None if x is None else x.data_ptr()


def flat_update_batch(theta, v, v0, u2, sent, g, ids, lrs, gammas, cgs,
                      vscales, hcs, *, nesterov: bool, b2: float = 0.999,
                      eps: float = 1e-8, dc_lambda: float | None = None,
                      sent_view: bool = False, hat_mode: str = "theta",
                      weights=None, telemetry: bool = False):
    """Launch the kernel: theta (R,128), v (N,R,128), v0/u2 (R,128) or
    None, sent (N,R,128) or None, g (k,R,128), all float32 on one CUDA
    device; ids (k,) host ints in [0, N); lrs/gammas/cgs/vscales/hcs (k,)
    host f32; weights (k, N) host f32 for hat_mode "weighted".

    Returns (theta, v, v0, u2, sent, hats (k,R,128), pres or None).
    """
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"flat_update_batch runs on CUDA tensors, got {dev}")
    if theta.dim() != 2:
        raise ValueError(f"theta must be (R, 128), got {tuple(theta.shape)}")
    r = theta.shape[0]
    n, k = v.shape[0], g.shape[0]
    _check("theta", theta, (r, 128), dev)
    _check("v", v, (n, r, 128), dev)
    _check("g", g, (k, r, 128), dev)
    if v0 is not None:
        _check("v0", v0, (r, 128), dev)
    if u2 is not None:
        _check("u2", u2, (r, 128), dev)
    if sent is not None:
        _check("sent", sent, (n, r, 128), dev)
    if hat_mode not in HAT_MODES:
        raise ValueError(f"unknown hat_mode {hat_mode!r}")
    if hat_mode == "v0" and v0 is None:
        raise ValueError("hat_mode 'v0' needs v0")
    if k < 1 or r < 1 or n < 1:
        raise ValueError(f"empty batch or state: k={k}, R={r}, N={n}")
    ids = np.asarray(ids)
    if ids.shape != (k,) or ids.min() < 0 or ids.max() >= n:
        raise ValueError(f"ids must be ({k},) in [0, {n}), got {ids}")
    scal = np.empty((6, k), np.float32)
    scal[0].view(np.int32)[:] = ids
    for row, x in enumerate((lrs, gammas, cgs, vscales, hcs), start=1):
        scal[row] = np.asarray(x, np.float32)
    # pinned + non_blocking: the upload does not wait for the stream
    scal_d = torch.from_numpy(scal).pin_memory().to(dev, non_blocking=True)
    w_d = None
    if hat_mode == "weighted":
        w = np.asarray(weights, np.float32)
        if w.shape != (k, n):
            raise ValueError(f"weights must be ({k}, {n}), got {w.shape}")
        w_d = torch.from_numpy(np.ascontiguousarray(w)).pin_memory().to(
            dev, non_blocking=True)
    hats = torch.empty((k, r, 128), dtype=torch.float32, device=dev)
    pres = (torch.empty((k, r, 128), dtype=torch.float32, device=dev)
            if telemetry else None)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flat_update_batch(
            _ptr(theta), _ptr(v), _ptr(v0), _ptr(u2), _ptr(sent), _ptr(g),
            _ptr(scal_d), _ptr(w_d), _ptr(hats), _ptr(pres), r, n, k,
            int(nesterov), int(u2 is not None), int(dc_lambda is not None),
            0.0 if dc_lambda is None else float(dc_lambda), int(sent_view),
            HAT_MODES[hat_mode], float(b2), float(1 - b2), float(eps),
            stream)
    _build.check(rc, "flat_update_batch")
    _build.LAUNCHES["flat_update_batch"] += 1
    return theta, v, v0, u2, sent, hats, pres
