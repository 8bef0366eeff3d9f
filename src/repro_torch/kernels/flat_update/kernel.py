"""The batched flat master updates on the card: wrappers of the CUDA
kernels ``flat_update_batch`` (``csrc/flat_update.cu``) and
``gap_update`` (``csrc/gap_update.cu``); each source states its kernel's
design and bound.

It replaces both TPU lowerings of the JAX package's ``kernel.py``: the
full-slab ``flat_master_update_batch_2d`` and the scalar-prefetch
``flat_master_update_batch_prefetch``.  The TPU picked between them by
its VMEM budget; the CUDA kernel reads only the slab rows a batch names
and has no limit on the worker count, so there is one entry point and no
routing.

The wrapper validates every tensor (CUDA, float32, contiguous, shapes),
uploads the gradient and hat pointer tables and the per-message scalars
as ONE small block, allocates the outputs, launches on the current
stream and raises on a launch error.  The state (theta, v, v0, u2,
sent) is updated in place.  The k gradients may be one (k, R, 128)
tensor or k separate (R, 128) tensors (no stacking copy); the k hats
come back as k (R, 128) tensors that each own their storage, so a
reply view that outlives its batch pins only itself.

``flat_update_batch_gap`` replaces the TPU's gap-aware
``gap_master_update_1``, chained k times by
``flat_master_update_batch_gap``: the one member (ga-asgd) whose update
needs a norm over all rows before it can touch any row.  Its per-message
scalars and pointers stay on the host and go to the launches as
arguments; ``avg_step`` stays on the device.
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
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (float4 access)")


def _ptr(x):
    return None if x is None else x.data_ptr()


def flat_update_batch(theta, v, v0, u2, sent, g, ids, lrs, gammas, cgs,
                      vscales, hcs, *, nesterov: bool, b2: float = 0.999,
                      eps: float = 1e-8, dc_lambda: float | None = None,
                      sent_view: bool = False, hat_mode: str = "theta",
                      weights=None, telemetry: bool = False):
    """Launch the kernel: theta (R,128), v (N,R,128), v0/u2 (R,128) or
    None, sent (N,R,128) or None, g (k,R,128) or k (R,128) tensors, all
    float32 on one CUDA device; ids (k,) host ints in [0, N);
    lrs/gammas/cgs/vscales/hcs (k,) host f32; weights (k, N) host f32 for
    hat_mode "weighted".

    Returns (theta, v, v0, u2, sent, hats (a list of k (R,128)
    tensors), pres (k,R,128) or None).
    """
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"flat_update_batch runs on CUDA tensors, got {dev}")
    if theta.dim() != 2:
        raise ValueError(f"theta must be (R, 128), got {tuple(theta.shape)}")
    r = theta.shape[0]
    gs = list(g)
    n, k = v.shape[0], len(gs)
    _check("theta", theta, (r, 128), dev)
    _check("v", v, (n, r, 128), dev)
    for j, gj in enumerate(gs):
        _check(f"g[{j}]", gj, (r, 128), dev)
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
    hats = [torch.empty((r, 128), dtype=torch.float32, device=dev)
            for _ in range(k)]
    # one block: k gradient pointers, k hat pointers, (6, k) scalars
    block = np.empty(40 * k, np.uint8)
    ptrs = block[:16 * k].view(np.int64)
    ptrs[:k] = [gj.data_ptr() for gj in gs]
    ptrs[k:] = [h.data_ptr() for h in hats]
    scal = block[16 * k:].view(np.float32).reshape(6, k)
    scal[0].view(np.int32)[:] = ids
    for row, x in enumerate((lrs, gammas, cgs, vscales, hcs), start=1):
        scal[row] = np.asarray(x, np.float32)
    # pinned + non_blocking: the upload does not wait for the stream
    block_d = torch.from_numpy(block).pin_memory().to(dev, non_blocking=True)
    w_d = None
    if hat_mode == "weighted":
        w = np.asarray(weights, np.float32)
        if w.shape != (k, n):
            raise ValueError(f"weights must be ({k}, {n}), got {w.shape}")
        w_d = torch.from_numpy(np.ascontiguousarray(w)).pin_memory().to(
            dev, non_blocking=True)
    pres = (torch.empty((k, r, 128), dtype=torch.float32, device=dev)
            if telemetry else None)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flat_update_batch(
            _ptr(theta), _ptr(v), _ptr(v0), _ptr(u2), _ptr(sent),
            _ptr(block_d), _ptr(w_d), _ptr(pres), r, n, k,
            int(nesterov), int(u2 is not None), int(dc_lambda is not None),
            0.0 if dc_lambda is None else float(dc_lambda), int(sent_view),
            HAT_MODES[hat_mode], float(b2), float(1 - b2), float(eps),
            stream)
    _build.check(rc, "flat_update_batch")
    _build.count("flat_update_batch")
    return theta, v, v0, u2, sent, hats, pres


GAP_MAX_BLOCKS = 1024          # kMaxBlocks of csrc/gap_update.cu


def flat_update_batch_gap(theta, v, sent, avg_step, g, ids, lrs, gammas,
                          cgs, vscales, *, gap_ema: float, n_elems: int,
                          telemetry: bool = False):
    """Launch the gap-aware kernel for k messages: theta (R,128), v and
    sent (N,R,128), avg_step a 0-d tensor, g (k,R,128) or k (R,128)
    tensors, all float32 on one CUDA device; ids (k,) host ints in
    [0, N); lrs/gammas/cgs/vscales (k,) host f32; ``n_elems`` the real
    (unpadded) element count the gap is normalised by.

    Updates theta, v, sent and avg_step in place and returns (theta, v,
    sent, avg_step, hats (a list of k (R,128) tensors), pres (k,R,128)
    or None).
    """
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"flat_update_batch_gap runs on CUDA tensors, "
                         f"got {dev}")
    if theta.dim() != 2:
        raise ValueError(f"theta must be (R, 128), got {tuple(theta.shape)}")
    r = theta.shape[0]
    gs = list(g)
    n, k = v.shape[0], len(gs)
    _check("theta", theta, (r, 128), dev)
    _check("v", v, (n, r, 128), dev)
    _check("sent", sent, (n, r, 128), dev)
    for j, gj in enumerate(gs):
        _check(f"g[{j}]", gj, (r, 128), dev)
    if not isinstance(avg_step, torch.Tensor) or avg_step.device != dev \
            or avg_step.dtype != torch.float32 or avg_step.numel() != 1:
        raise ValueError("avg_step must be a one-element float32 tensor "
                         f"on {dev}")
    if k < 1 or r < 1 or n < 1:
        raise ValueError(f"empty batch or state: k={k}, R={r}, N={n}")
    if not 0 < n_elems <= r * 128:
        raise ValueError(f"n_elems must be in (0, {r * 128}], got {n_elems}")
    ids = np.ascontiguousarray(ids, np.int32)
    if ids.shape != (k,) or ids.min() < 0 or ids.max() >= n:
        raise ValueError(f"ids must be ({k},) in [0, {n}), got {ids}")
    hats = [torch.empty((r, 128), dtype=torch.float32, device=dev)
            for _ in range(k)]
    pres = (torch.empty((k, r, 128), dtype=torch.float32, device=dev)
            if telemetry else None)
    partials = torch.empty((2 * GAP_MAX_BLOCKS,), dtype=torch.float32,
                           device=dev)
    g_ptrs = np.asarray([gj.data_ptr() for gj in gs], np.uint64)
    hat_ptrs = np.asarray([h.data_ptr() for h in hats], np.uint64)
    scal = np.ascontiguousarray(
        [np.asarray(x, np.float32).reshape(k)
         for x in (lrs, gammas, cgs, vscales)], np.float32)
    # f32-rounded like the plain version's sqrt(float32(n_elems))
    sqrt_p = np.sqrt(np.float32(n_elems), dtype=np.float32)
    lib = _build.GAP_LIB.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gap_update_batch(
            _ptr(theta), _ptr(v), _ptr(sent), _ptr(avg_step),
            _ptr(partials), _ptr(pres), g_ptrs.ctypes.data,
            hat_ptrs.ctypes.data, ids.ctypes.data, scal.ctypes.data, r, n,
            k, float(sqrt_p), float(np.float32(gap_ema)),
            float(np.float32(1 - gap_ema)), stream)
    _build.check(rc, "gap_update")
    _build.count("gap_update", k)
    return theta, v, sent, avg_step, hats, pres
