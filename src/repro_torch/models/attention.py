"""GQA attention: the flash-attention prefill path (causal with or
without a sliding window, non-causal, cross attention, packed segments),
the unified ring-buffer KV-cache decode path and RoPE.

``flash_attention`` goes through ``kernels.swa_attention.swa_attention``
on every device (the CUDA kernel on the card, its plain version on the
CPU), where the JAX package runs its chunked ``jnp`` flash recurrence and
names the Pallas kernel as the TPU route for the windowed case.  Dense
causal attention (the ``attn`` kind) is the windowed function with a
window of S; the encoder's ``attn_bidir`` and ``cross_attention`` (queries
over the encoder's T frames) are its non-causal case; ``segments`` (B, S)
confine each query to its own packed document, a segment-0 (padding) row
taking the mean of V over every key, as the JAX recurrence gives it
(with a window the JAX path averages only its band's kv chunks, so past
the band its padding rows differ: ROADMAP C33; no target and no other
row reads them).

``_project_qkv`` with ``x_kv`` (cross attention) casts the weights to the
query side's type and computes K and V in the wider of the two types, as
JAX's ``einsum`` promotes a bfloat16 encoder output against float32
weights (an exact cast).

``decode_attention`` is plain PyTorch (einsums in the JAX package, no
Pallas kernel there).  With ``CacheSpec(quant=True)`` the cache holds
int8 K/V with a float32 scale per (batch, position, head)
(``quantize_kv``: amax / 127 floored at 1e-8, rounded half to even,
clipped to +-127), and decode attends over the dequantized float32 K/V,
as in the JAX package.  It takes the step ``t`` as a scalar with ``pos``
of shape (capacity,), as ``generate`` runs it, or one step per row,
``t`` of shape (B,) with ``pos`` of shape (B, capacity), as the
continuous-batching Engine runs it: each row writes its own ring slot
``t_b % capacity``, masks against its own ``t_b`` and takes RoPE position
``t_b``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.swa_attention import swa_attention
from .common import (default_mrope_sections, dense_init, rope_1d,
                     rope_2d_partial, rope_mrope)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    capacity: int               # full seq len, or window size for SWA
    window: int | None          # sliding window, None = full attention
    quant: bool = False         # int8 KV cache (per-position/head scales)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def init_attention(gen, d_model, num_heads, num_kv_heads, head_dim,
                   qkv_bias=False, device="cuda", dtype=torch.float32):
    def dense(shape, in_axes=(0,)):
        return dense_init(gen, shape, in_axes, dtype, device)

    p = {
        "wq": dense((d_model, num_heads, head_dim)),
        "wk": dense((d_model, num_kv_heads, head_dim)),
        "wv": dense((d_model, num_kv_heads, head_dim)),
        "wo": dense((num_heads, head_dim, d_model), in_axes=(0, 1)),
    }
    if qkv_bias:
        for name, heads in (("bq", num_heads), ("bk", num_kv_heads),
                            ("bv", num_kv_heads)):
            p[name] = torch.zeros((heads, head_dim), dtype=dtype,
                                  device=device)
    return p


def _proj(x, w):
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(
        *x.shape[:-1], h, k)


def _project_qkv(params, x, x_kv=None):
    """q from x; k, v from ``x_kv`` (cross attention) or x.  The weights
    are cast to x's type; K and V take the wider of x's and x_kv's types
    (JAX's einsum promotion)."""
    if x_kv is None:
        x_kv = x
    else:
        x_kv = x_kv.to(torch.promote_types(x.dtype, x_kv.dtype))
    q = _proj(x, params["wq"])
    k = _proj(x_kv, params["wk"].to(x.dtype))
    v = _proj(x_kv, params["wv"].to(x.dtype))
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def apply_rope(q, k, rope, positions):
    """rope: 'none'|'1d'|'2d'|'mrope'; positions: (B,S), or (3,B,S) for
    'mrope'."""
    if rope == "none":
        return q, k
    if rope == "1d":
        return rope_1d(q, positions), rope_1d(k, positions)
    if rope == "2d":
        return rope_2d_partial(q, positions), rope_2d_partial(k, positions)
    if rope == "mrope":
        sec = default_mrope_sections(q.shape[-1])
        return rope_mrope(q, positions, sec), rope_mrope(k, positions, sec)
    raise ValueError(rope)


def attention_block_output(params, attn_out, x_dtype):
    """einsum('bshk,hkd->bsd', attn_out, wo)."""
    h, k, d = params["wo"].shape
    return attn_out.reshape(*attn_out.shape[:-2], h * k) @ \
        params["wo"].to(x_dtype).reshape(h * k, d)


# ---------------------------------------------------------------------------
# flash attention (train / prefill)
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal=True, window=None, segments=None):
    """q: (B,S,H,hd); k, v: (B,T,K,hd) with H = K*G.  Returns (B,S,H,hd).

    ``swa_attention``'s function: causal (T == S) within ``window``, or
    up to each query when it is None; non-causal (no window) over all T
    keys; ``segments`` (B,S) ints confine attention to each packed
    document (0 = padding, attends nowhere)."""
    if segments is not None:
        segments = segments.to(device=q.device,
                               dtype=torch.int32).contiguous()
    return swa_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         window, causal=causal, segments=segments)


def cross_attention(q, k, v):
    """Non-causal attention against a fixed (encoder) memory."""
    return flash_attention(q, k, v, causal=False, window=None)


# ---------------------------------------------------------------------------
# decode with a unified (full or ring-buffer) KV cache
# ---------------------------------------------------------------------------
def init_kv_cache(batch, capacity, num_kv_heads, head_dim,
                  dtype=torch.bfloat16, quant=False, device="cuda"):
    """Empty cache: ``k``, ``v`` (B, capacity, K, hd) in ``dtype``, or
    int8 with float32 ``k_scale``, ``v_scale`` (B, capacity, K) when
    ``quant``; ``pos`` (capacity,) int32, -1 where unwritten."""
    shape = (batch, capacity, num_kv_heads, head_dim)
    if quant:
        cache = {name: torch.zeros(shape, dtype=torch.int8, device=device)
                 for name in ("k", "v")}
        cache.update({name: torch.zeros(shape[:3], dtype=torch.float32,
                                        device=device)
                      for name in ("k_scale", "v_scale")})
    else:
        cache = {name: torch.zeros(shape, dtype=dtype, device=device)
                 for name in ("k", "v")}
    cache["pos"] = torch.full((capacity,), -1, dtype=torch.int32,
                              device=device)
    return cache


def quantize_kv(x):
    """Symmetric int8 per-(batch, position, head): returns (q int8,
    scale float32 of x's shape without its last axis)."""
    xf = x.float()
    scale = torch.clamp_min(torch.amax(torch.abs(xf), dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    return (q.float() * scale[..., None]).to(dtype)


def decode_attention(params, x, cache, t, spec: CacheSpec, rope="1d",
                     positions=None):
    """One-token decode. x: (B,1,d); t: () or (B,) absolute position(s).

    Writes the new K/V at slot ``t % capacity`` (cast to the cache's
    type), then attends in float32 over every valid slot: written
    (``pos >= 0``), not after ``t`` and, for sliding windows, after
    ``t - window``.  Returns (y (B,1,d), new cache); the old cache is not
    written to."""
    b = x.shape[0]
    per_row = t.dim() == 1
    t_b = t if per_row else t.expand(b)
    q, k_new, v_new = _project_qkv(params, x)
    if positions is None:
        positions = t_b[:, None]
    q, k_new = apply_rope(q, k_new, rope, positions)
    slot = torch.remainder(t_b, spec.capacity).long()
    rows = torch.arange(b, device=x.device)

    def put(name, new):
        return cache[name].index_put((rows, slot),
                                     new[:, 0].to(cache[name].dtype))

    if spec.quant:
        (k8, ks), (v8, vs) = quantize_kv(k_new), quantize_kv(v_new)
        new_cache = {"k": put("k", k8), "v": put("v", v8),
                     "k_scale": put("k_scale", ks),
                     "v_scale": put("v_scale", vs)}
        k = dequantize_kv(new_cache["k"], new_cache["k_scale"])
        v = dequantize_kv(new_cache["v"], new_cache["v_scale"])
    else:
        new_cache = {"k": put("k", k_new), "v": put("v", v_new)}
        k, v = new_cache["k"], new_cache["v"]
    if per_row:
        pos = cache["pos"].index_put((rows, slot), t_b.to(torch.int32))
        tt = t_b[:, None]                                   # (B,1)
    else:
        pos = cache["pos"].index_put((slot[:1],), t.reshape(1).to(
            torch.int32))
        tt = t
    new_cache["pos"] = pos
    valid = (pos >= 0) & (pos <= tt)
    if spec.window is not None:
        valid &= pos > tt - spec.window
    valid = valid.reshape(-1 if per_row else 1, 1, 1, pos.shape[-1])

    kh = k.shape[2]
    g = q.shape[2] // kh
    hd = q.shape[-1]
    qh = q.reshape(b, kh, g, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    s_ = torch.einsum("bkgh,btkh->bkgt", qh.float(),
                      k.float()) * scale.to(x.device)
    s_ = torch.where(valid, s_, torch.tensor(NEG_INF, device=x.device))
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    out = out.reshape(b, 1, kh * g, hd).to(x.dtype)
    y = attention_block_output(params, out, x.dtype)
    return y, new_cache
