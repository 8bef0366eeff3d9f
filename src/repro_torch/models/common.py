"""Shared model building blocks: initializers, the RMS norm, the
cross-entropy loss and RoPE.

Models are plain trees of tensors (nested dicts and lists) and plain
functions over them, as in the JAX package.  Initializers draw from an
explicit ``torch.Generator`` on an explicit device; the numbers differ
from ``jax.random``'s, so the parity tests carry the JAX package's
weights across (``convert.lm_params_from_numpy``).

RoPE comes in the JAX package's three variants: ``rope_1d``,
chatglm's ``rope_2d_partial`` (the first half of each head rotates) and
qwen2-vl's ``rope_mrope`` (the frequency bands split into temporal,
height and width sections, each rotated by its own row of (3, B, S)
positions).  Every rotation is float32, cast back to x's type.

Not ported: the logical-axis rules and the mesh (``with_logical_constraint``
and friends: ROADMAP A8) and the ``kernel_dispatch`` switch (each
kernel's wrapper picks the CUDA kernel or the plain version by the device
of its tensors).
"""
from __future__ import annotations

import math

import torch


def dense_init(gen, shape, in_axes=(0,), dtype=torch.float32,
               device="cuda"):
    """Normal(0, 1/fan_in) in float32, cast to ``dtype``."""
    fan_in = math.prod(shape[a] for a in in_axes)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    # in place: one float32 copy of the leaf at a time (llama4-scout's
    # expert leaves are 2.7 GB each in float32)
    return w.mul_(math.sqrt(1.0 / fan_in)).to(dtype)


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


def rope_2d_partial(x, positions, theta: float = 10000.0):
    """ChatGLM-style: the rotary frequencies of head_dim / 2, so only the
    first half of each head rotates (the other half carries no
    positional signal).  x: (B, S, H, hd); positions: (B, S) int."""
    freqs = _rope_freqs(x.shape[-1] // 2, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    return _apply_rotary(x, angles[:, :, None, :])


def rope_mrope(x, positions3, sections=(16, 24, 24), theta: float = 10000.0):
    """Qwen2-VL M-RoPE: the rotary frequency bands are split into
    (temporal, height, width) sections, each rotated by its own position
    row.  x: (B, S, H, hd); positions3: (3, B, S) int.

    The JAX package gathers a position row per band (``jnp.take`` on axis
    0) and multiplies by the frequencies; here each section's row
    multiplies its slice of the frequencies, the same float32 products."""
    d2 = x.shape[-1] // 2
    assert sum(sections) == d2, (sections, d2)
    freqs = _rope_freqs(x.shape[-1], theta, x.device)       # (d2,)
    pos = positions3.to(torch.float32)                      # (3,B,S)
    parts, lo = [], 0
    for i, s in enumerate(sections):
        parts.append(pos[i][..., None] * freqs[lo:lo + s])
        lo += s
    angles = torch.cat(parts, dim=-1)                       # (B,S,d2)
    return _apply_rotary(x, angles[:, :, None, :])


def default_mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """(temporal, height, width) band counts: a quarter of the d2 bands
    temporal, the rest split in two (the odd one to width)."""
    d2 = head_dim // 2
    t = d2 // 4
    rest = d2 - t
    h = rest // 2
    return (t, h, rest - h)
