"""Weighted-slab reduction: the flat send path's view construction.

Every look-ahead send in the family is the same shape over flat rows:

    view = theta - c * sum_j w[j] * slab[j]          [/ (sqrt(u2) + eps)]

with a (N, R, 128) slab, an (N,) weight vector, and a host scalar
c = lr(t) [* gamma] [* tau] [* vscale] (``SendSpec`` in ``ops.py`` says
which factors an algorithm uses):

  dana-zero / dana-dc   slab = v0[None],  w = [1]      c = lr*gamma*vs
  dana-nadam            slab = m0[None],  w = [1]      c = lr*b1, adaptive
  lwp                   slab = v[None],   w = [1]      c = lr*tau*vs
  dana-hetero           slab = v (all N), w = r_j/r_i  c = lr*gamma*vs
  asgd / theta-senders  no reduction at all: the view IS theta

``flat_send_view`` launches the CUDA kernel ``send_view``
(``csrc/flat_update.cu``; it replaces the JAX package's
``send.py::_send_view_pallas``) for CUDA tensors and runs the plain
version ``flat_send_view_ref`` for CPU tensors.  The plain version is the
tree path's expression on flat rows (``tensordot`` + axpy).

The kernel is element-parallel (a float4 of the row space a thread) and
moves 4*R*128*(N + 2 [+ 1 for u2]) bytes, at 89-93 % of the card's
memory rate in all three of its modes; its call is mostly host work at
N=1.  So the wrapper takes the lean launch path: the checks (device,
float32, shapes, contiguity, 16-byte alignment) in one pass, the output
allocated, ``_build.launch`` (the current stream's raw handle, no device
context on the current device), the counter.  The checks are
``kernel._check_all``'s, which name the tensor at fault.

The slab may be a row range ``slab[:, r0:r1]`` of a larger slab (a
hot-row pull, a shard's reply): the kernel takes the elements between
one worker's rows and the next's (the pitch) and reads the range where
it lies.  Each worker's rows must be contiguous; any other layout is
refused.
"""
from __future__ import annotations

import torch

from . import _build
from .kernel import _check_all
from ...core.types import sqrt_rn


def flat_send_view_ref(theta, slab, w, c, u2=None, eps: float = 1e-8):
    """The plain version: the tree path's expression on flat rows."""
    wsum = torch.tensordot(w, slab, dims=1)
    if u2 is not None:
        return theta - (c * wsum) / (sqrt_rn(u2) + eps)
    return (-c) * wsum + theta


def _send_checks(theta, slab, w, u2):
    """One pass over the inputs; returns (R, N, slab pitch) or raises the
    first fault.  The slab passes ``_check_all`` through its first
    worker's rows (device, dtype, shape, contiguous rows, alignment);
    for N > 1 its pitch must be a multiple of 4 (float4 access) and at
    least R*128 (workers' rows do not overlap)."""
    if not (isinstance(theta, torch.Tensor) and theta.dim() == 2
            and isinstance(slab, torch.Tensor) and slab.dim() == 3):
        raise ValueError(f"theta must be (R, 128) and slab (N, R, 128), "
                         f"got {getattr(theta, 'shape', theta)}, "
                         f"{getattr(slab, 'shape', slab)}")
    r, n = theta.shape[0], slab.shape[0]
    if r < 1 or n < 1:
        raise ValueError(f"empty view: R={r}, N={n}")
    named = [("theta", theta, (r, 128)), ("slab[0]", slab[0], (r, 128)),
             ("w", w, (n,))]
    if u2 is not None:
        named.append(("u2", u2, (r, 128)))
    _check_all(named, theta.device)
    if n == 1:
        return r, n, r * 128
    pitch = slab.stride(0)
    if pitch < r * 128 or pitch % 4:
        raise ValueError(f"slab pitch {pitch} must be a multiple of 4 "
                         f"and at least {r * 128} (R x 128)")
    return r, n, pitch


def _send_view_cuda(theta, slab, w, c, u2, eps):
    r, n, pitch = _send_checks(theta, slab, w, u2)
    out = torch.empty_like(theta)
    rc = _build.launch(_build.load().send_view, theta.get_device(),
                       theta.data_ptr(), slab.data_ptr(), w.data_ptr(),
                       float(c), None if u2 is None else u2.data_ptr(),
                       float(eps), out.data_ptr(), r, n, pitch)
    if rc:
        _build.check(rc, "send_view")
    _build.count("send_view")
    return out


def flat_send_view(theta, slab, w, c, u2=None, *, eps: float = 1e-8):
    """view = theta - c * sum_j w[j]*slab[j] [/ (sqrt(u2)+eps)].

    theta (R, 128); slab (N, R, 128), each worker's rows contiguous
    (``slab[:, r0:r1]`` of a larger slab is read in place); w (N,)
    float32 on theta's device; c a host scalar.  The CUDA kernel for CUDA tensors (or an error), the
    plain version for CPU tensors.
    """
    if theta.is_cuda:
        return _send_view_cuda(theta, slab, w, c, u2, eps)
    if theta.device.type == "cpu":
        return flat_send_view_ref(theta, slab, w, c, u2=u2, eps=eps)
    raise ValueError(f"no send view for device {theta.device}")
