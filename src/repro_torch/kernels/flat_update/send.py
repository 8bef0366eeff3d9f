"""Weighted-slab reduction: the flat send path's view construction.

Every look-ahead send in the family is the same shape over flat rows:

    view = theta - c * sum_j w[j] * slab[j]          [/ (sqrt(u2) + eps)]

with a (N, R, 128) slab, an (N,) weight vector, and a host scalar
c = lr(t) [* gamma] [* vscale] (``SendSpec`` in ``ops.py`` says which
factors an algorithm uses):

  dana-zero             slab = v0[None],  w = [1]      c = lr*gamma*vs
  asgd / theta-senders  no reduction at all: the view IS theta

``flat_send_view`` launches the CUDA kernel ``send_view``
(``csrc/flat_update.cu``; it replaces the JAX package's
``send.py::_send_view_pallas``) for CUDA tensors and runs the plain
version ``flat_send_view_ref`` for CPU tensors.  The plain version is the
tree path's expression on flat rows (``tensordot`` + axpy).
"""
from __future__ import annotations

import torch

from . import _build
from .kernel import _check, _ptr
from .ref import sqrt_rn


def flat_send_view_ref(theta, slab, w, c, u2=None, eps: float = 1e-8):
    """The plain version: the tree path's expression on flat rows."""
    wsum = torch.tensordot(w, slab, dims=1)
    if u2 is not None:
        return theta - (c * wsum) / (sqrt_rn(u2) + eps)
    return (-c) * wsum + theta


def _send_view_cuda(theta, slab, w, c, u2, eps):
    dev = theta.device
    if theta.dim() != 2 or slab.dim() != 3:
        raise ValueError(f"theta must be (R, 128) and slab (N, R, 128), "
                         f"got {tuple(theta.shape)}, {tuple(slab.shape)}")
    r, n = theta.shape[0], slab.shape[0]
    if r < 1 or n < 1:
        raise ValueError(f"empty view: R={r}, N={n}")
    _check("theta", theta, (r, 128), dev)
    _check("slab", slab, (n, r, 128), dev)
    _check("w", w, (n,), dev)
    if u2 is not None:
        _check("u2", u2, (r, 128), dev)
    out = torch.empty_like(theta)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.send_view(_ptr(theta), _ptr(slab), _ptr(w), float(c),
                           _ptr(u2), float(eps), _ptr(out), r, n, stream)
    _build.check(rc, "send_view")
    _build.LAUNCHES["send_view"] += 1
    return out


def flat_send_view(theta, slab, w, c, u2=None, *, eps: float = 1e-8):
    """view = theta - c * sum_j w[j]*slab[j] [/ (sqrt(u2)+eps)].

    theta (R, 128); slab (N, R, 128); w (N,) float32 on theta's device;
    c a host scalar.  The CUDA kernel for CUDA tensors (or an error), the
    plain version for CPU tensors.
    """
    if theta.device.type == "cuda":
        return _send_view_cuda(theta, slab, w, c, u2, eps)
    if theta.device.type == "cpu":
        return flat_send_view_ref(theta, slab, w, c, u2=u2, eps=eps)
    raise ValueError(f"no send view for device {theta.device}")
