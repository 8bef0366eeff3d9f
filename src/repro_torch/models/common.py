"""Shared model building blocks: initializers and the RMS norm.

Models are plain trees of tensors (nested dicts and lists) and plain
functions over them, as in the JAX package.  Initializers draw from an
explicit ``torch.Generator`` on an explicit device; the numbers differ
from ``jax.random``'s, so the parity tests carry the JAX package's
weights across (``convert.lm_params_from_numpy``).

Not ported: the logical-axis rules and the mesh (``with_logical_constraint``
and friends: ROADMAP A8), and the ``kernel_dispatch`` switch: the scan
wrapper picks the CUDA kernel or the plain version by the device of its
tensors, as every kernel of the port does.
"""
from __future__ import annotations

import math

import torch


def dense_init(gen, shape, in_axes=(0,), dtype=torch.float32,
               device="cuda"):
    """Normal(0, 1/fan_in) in float32, cast to ``dtype``."""
    fan_in = math.prod(shape[a] for a in in_axes)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * math.sqrt(1.0 / fan_in)).to(dtype)


def embed_init(gen, shape, dtype=torch.float32, device="cuda"):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.to(dtype) * 0.02


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in float32 with a zero-centred scale, cast back to x's
    type (as the JAX package computes it)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)
