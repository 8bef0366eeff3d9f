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

Lean launch path, in both wrappers: every tensor is checked (CUDA,
one device, float32, shape, contiguity, 16-byte alignment) in one pass
that raises the first fault it finds;
``_build.launch`` launches on the current stream with no device context
when the state lies on the current device; a launch error raises.

``flat_update_batch`` uploads the gradient and hat pointer tables and
the per-message scalars as ONE small block, allocates the outputs and
launches once.  The state (theta, v, v0, u2, sent) is updated in place.
The k gradients may be one (k, R, 128) tensor or k separate (R, 128)
tensors (no stacking copy); the k hats come back as k (R, 128) tensors
that each own their storage, so a reply view that outlives its batch
pins only itself.

``flat_update_batch_gap`` replaces the TPU's gap-aware
``gap_master_update_1``, chained k times by
``flat_master_update_batch_gap``: the one member (ga-asgd) whose update
needs a norm over all rows before it can touch any row.  It takes k + 2
launches for k messages (one pass over the state each, the next
message's norm folded in).  Its per-message scalars and pointers stay on
the host and go to the launches as arguments; ``avg_step`` and the
partial sums stay on the device, the sums in a scratch buffer of each
call's own.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

HAT_MODES = {"theta": 0, "v0": 1, "self": 2, "weighted": 3}
_F32 = torch.float32


def _fault(name, x, shape, idx):
    """The first condition ``x`` fails, as (exception type, message), or
    None: a CUDA float32 tensor on device ``idx``, of ``shape``,
    contiguous and 16-byte aligned (float4 access)."""
    if not isinstance(x, torch.Tensor):
        return TypeError, f"{name} must be a tensor"
    if x.get_device() != idx:
        return ValueError, f"{name} is on {x.device}, expected cuda:{idx}"
    if x.dtype is not _F32:
        return TypeError, f"{name} must be float32, got {x.dtype}"
    if x.shape != shape:
        return ValueError, (f"{name} has shape {tuple(x.shape)}, expected "
                            f"{tuple(shape)}")
    if not x.is_contiguous():
        return ValueError, f"{name} must be contiguous"
    if x.data_ptr() % 16:
        return ValueError, f"{name} must be 16-byte aligned (float4 access)"
    return None


def _check_all(named, device) -> None:
    """One pass over (name, tensor, shape) triples; raises the first
    fault."""
    idx = device.index
    for name, x, shape in named:
        fault = _fault(name, x, shape, idx)
        if fault:
            raise fault[0](fault[1])


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
    if not (isinstance(theta, torch.Tensor) and theta.is_cuda):
        raise ValueError(f"flat_update_batch runs on CUDA tensors, got "
                         f"{getattr(theta, 'device', type(theta))}")
    if theta.dim() != 2:
        raise ValueError(f"theta must be (R, 128), got {tuple(theta.shape)}")
    dev = theta.device
    r = theta.shape[0]
    gs = list(g)
    n, k = v.shape[0], len(gs)
    rs, ss = (r, 128), (n, r, 128)
    named = [("theta", theta, rs), ("v", v, ss)]
    named += [(f"g[{j}]", gj, rs) for j, gj in enumerate(gs)]
    if v0 is not None:
        named.append(("v0", v0, rs))
    if u2 is not None:
        named.append(("u2", u2, rs))
    if sent is not None:
        named.append(("sent", sent, ss))
    _check_all(named, dev)
    if hat_mode not in HAT_MODES:
        raise ValueError(f"unknown hat_mode {hat_mode!r}")
    if hat_mode == "v0" and v0 is None:
        raise ValueError("hat_mode 'v0' needs v0")
    if k < 1 or r < 1 or n < 1:
        raise ValueError(f"empty batch or state: k={k}, R={r}, N={n}")
    ids = np.asarray(ids)
    if ids.shape != (k,) or ids.min() < 0 or ids.max() >= n:
        raise ValueError(f"ids must be ({k},) in [0, {n}), got {ids}")
    w = None
    if hat_mode == "weighted":
        w = np.asarray(weights, np.float32)
        if w.shape != (k, n):
            raise ValueError(f"weights must be ({k}, {n}), got {w.shape}")
    hats = [torch.empty(rs, dtype=_F32, device=dev) for _ in range(k)]
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
    w_d = None if w is None else torch.from_numpy(
        np.ascontiguousarray(w)).pin_memory().to(dev, non_blocking=True)
    pres = (torch.empty((k, r, 128), dtype=_F32, device=dev)
            if telemetry else None)
    rc = _build.launch(
        _build.load().flat_update_batch, dev.index,
        _ptr(theta), _ptr(v), _ptr(v0), _ptr(u2), _ptr(sent),
        _ptr(block_d), _ptr(w_d), _ptr(pres), r, n, k,
        int(nesterov), int(u2 is not None), int(dc_lambda is not None),
        0.0 if dc_lambda is None else float(dc_lambda), int(sent_view),
        HAT_MODES[hat_mode], float(b2), float(1 - b2), float(eps))
    if rc:
        _build.check(rc, "flat_update_batch")
    _build.count("flat_update_batch")
    return theta, v, v0, u2, sent, hats, pres


GAP_MAX_BLOCKS = 1024          # kMaxBlocks of csrc/gap_update.cu
# two norm and two step partial buffers and two avg_step slots
GAP_SCRATCH = 4 * GAP_MAX_BLOCKS + 2


def flat_update_batch_gap(theta, v, sent, avg_step, g, ids, lrs, gammas,
                          cgs, vscales, *, gap_ema: float, n_elems: int,
                          telemetry: bool = False):
    """Launch the gap-aware kernels for k messages (k + 2 launches, one
    pass over the state per message): theta (R,128), v and sent
    (N,R,128), avg_step a 0-d tensor, g (k,R,128) or k (R,128) tensors,
    all float32 on one CUDA device; ids (k,) host ints in [0, N);
    lrs/gammas/cgs/vscales (k,) host f32; ``n_elems`` the real
    (unpadded) element count the gap is normalised by.

    Updates theta, v, sent and avg_step in place and returns (theta, v,
    sent, avg_step, hats (a list of k (R,128) tensors), pres (k,R,128)
    or None).  The partial sums go to a scratch buffer of the call's
    own, from the caching allocator, so calls on several streams or
    threads do not share it.
    """
    if not (isinstance(theta, torch.Tensor) and theta.is_cuda):
        raise ValueError(f"flat_update_batch_gap runs on CUDA tensors, "
                         f"got {getattr(theta, 'device', type(theta))}")
    if theta.dim() != 2:
        raise ValueError(f"theta must be (R, 128), got {tuple(theta.shape)}")
    dev = theta.device
    r = theta.shape[0]
    gs = list(g)
    n, k = v.shape[0], len(gs)
    rs, ss = (r, 128), (n, r, 128)
    _check_all([("theta", theta, rs), ("v", v, ss), ("sent", sent, ss)]
               + [(f"g[{j}]", gj, rs) for j, gj in enumerate(gs)], dev)
    if not (isinstance(avg_step, torch.Tensor) and avg_step.device == dev
            and avg_step.dtype is _F32 and avg_step.numel() == 1):
        raise ValueError("avg_step must be a one-element float32 tensor "
                         f"on {dev}")
    if k < 1 or r < 1 or n < 1:
        raise ValueError(f"empty batch or state: k={k}, R={r}, N={n}")
    if not 0 < n_elems <= r * 128:
        raise ValueError(f"n_elems must be in (0, {r * 128}], got {n_elems}")
    ids = np.ascontiguousarray(ids, np.int32)
    if ids.shape != (k,) or ids.min() < 0 or ids.max() >= n:
        raise ValueError(f"ids must be ({k},) in [0, {n}), got {ids}")
    hats = [torch.empty(rs, dtype=_F32, device=dev) for _ in range(k)]
    pres = (torch.empty((k, r, 128), dtype=_F32, device=dev)
            if telemetry else None)
    scratch = torch.empty((GAP_SCRATCH,), dtype=_F32, device=dev)
    g_ptrs = np.asarray([gj.data_ptr() for gj in gs], np.uint64)
    hat_ptrs = np.asarray([h.data_ptr() for h in hats], np.uint64)
    scal = np.ascontiguousarray(
        [np.asarray(x, np.float32).reshape(k)
         for x in (lrs, gammas, cgs, vscales)], np.float32)
    # f32-rounded like the plain version's sqrt(float32(n_elems))
    sqrt_p = np.sqrt(np.float32(n_elems), dtype=np.float32)
    rc = _build.launch(
        _build.GAP_LIB.load().gap_update_batch, dev.index,
        _ptr(theta), _ptr(v), _ptr(sent), _ptr(avg_step),
        _ptr(scratch), _ptr(pres), g_ptrs.ctypes.data,
        hat_ptrs.ctypes.data, ids.ctypes.data, scal.ctypes.data, r, n, k,
        float(sqrt_p), float(np.float32(gap_ema)),
        float(np.float32(1 - gap_ema)))
    if rc:
        _build.check(rc, "gap_update")
    _build.count("gap_update", k)
    return theta, v, sent, avg_step, hats, pres
