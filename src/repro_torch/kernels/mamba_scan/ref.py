"""Plain PyTorch version of the Mamba-1 selective scan, the oracle of the
CUDA kernel ``mamba_scan`` (the JAX package's ``mamba_scan_ref``):

    h_t = exp(delta_t * A) * h_{t-1} + (delta_t * x_t) B_t
    y_t = C_t . h_t

It takes the kernel's inputs as they lie (x, B and C in float32 or
bfloat16, B and C possibly column slices of one projection) and widens
them to float32 first, which is exact, as the kernel does in registers.
A loop over t, each step in the JAX reference's order of operations, so
the state rounds as the kernel (built with ``-fmad=false``) rounds it;
the N-sum of y is ``torch.sum``'s.
"""
from __future__ import annotations

import torch


def mamba_scan_ref(x, delta, b, c, a, h0):
    """x, delta: (B,S,D); b, c: (B,S,N); a: (D,N); h0: (B,D,N).
    Returns (y (B,S,D) float32, h_last (B,D,N))."""
    x, b, c = x.float(), b.float(), c.float()
    h = h0
    ys = []
    for t in range(x.shape[1]):
        d_t = delta[:, t]                                  # (B,D)
        abar = torch.exp(d_t[..., None] * a)               # (B,D,N)
        h = abar * h + (d_t * x[:, t])[..., None] * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) if ys else torch.empty_like(delta)
    return y, h
