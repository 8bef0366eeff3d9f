"""Shared model building blocks: initializers, the RMS norm, the
cross-entropy loss and RoPE.

Models are plain trees of tensors (nested dicts and lists) and plain
functions over them, as in the JAX package.  Initializers draw from an
explicit ``torch.Generator`` on an explicit device; the numbers differ
from ``jax.random``'s, so the parity tests carry the JAX package's
weights across (``convert.lm_params_from_numpy``).

Not ported: the logical-axis rules and the mesh (``with_logical_constraint``
and friends: ROADMAP A8), the ``kernel_dispatch`` switch (each kernel's
wrapper picks the CUDA kernel or the plain version by the device of its
tensors), and the 2-D and M-RoPE variants (their families, A7(d)),
which raise.
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


def softmax_xent_logits(logits, labels, mask=None):
    """Mean next-token cross entropy in float32; labels == -1 are
    ignored, and so are positions where ``mask`` is 0."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    if mask is not None:
        valid = valid * mask.float()
    return torch.sum((logz - gold) * valid) / torch.clamp_min(
        torch.sum(valid), 1.0)


def silu(x):
    """x * sigmoid(x), as ``jax.nn.silu``."""
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def _rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    """1 / theta^(i/d2) for i < d2, in float32 as the JAX package computes
    it: a float32 arange over d2, a float32 power.  At position 4096 one
    ulp of a frequency moves the angle by about 2e-4 rad."""
    d2 = head_dim // 2
    expo = torch.arange(0, d2, dtype=torch.float32, device=device) / d2
    # torch.full, not torch.tensor: no host-to-device copy (which waits
    # for the stream) in every attention layer's forward
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), expo)


def _apply_rotary(x, angles):
    """x: (..., 2*d2) pairs-last layout; angles broadcastable (..., d2).
    The rotation is float32 (x times a float32 cos), cast back to x's
    type."""
    d2 = angles.shape[-1]
    x1, x2 = x[..., :d2], x[..., d2:2 * d2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1, r2], dim=-1)
    if x.shape[-1] > 2 * d2:  # partial rotary
        out = torch.cat([out, x[..., 2 * d2:].to(out.dtype)], dim=-1)
    return out.to(x.dtype)


def rope_1d(x, positions, theta: float = 10000.0):
    """Standard RoPE. x: (B, S, H, hd); positions: (B, S) int."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs   # (B,S,d2)
    return _apply_rotary(x, angles[:, :, None, :])


def rope_2d_partial(*args, **kwargs):
    raise NotImplementedError("2-D partial RoPE (chatglm) is not ported "
                              "yet: ROADMAP A7(d), the dense family")


def rope_mrope(*args, **kwargs):
    raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet: "
                              "ROADMAP A7(d), the VLM family")
