"""Residual blocks by kind and their decode caches.

Kinds: ``mamba`` (falcon-mamba's standalone Mamba-1 block),
recurrentgemma's ``rec`` (RG-LRU + MLP) and ``attn_local`` (sliding-window
attention + MLP), the decoder-only families' ``attn`` (full causal
attention + FFN: ``swa_attention`` with a window of S, a cache of the
spec's full capacity, or its window where the spec sets one), and the
enc-dec family's ``attn_bidir`` (the encoder's non-causal self-attention
+ FFN) and ``attn_cross`` (causal self-attention, cross attention over
the encoder output ``ctx["enc_out"]`` without RoPE, then the FFN; its
cache is ``{"self": K/V ring, "cross": the encoder's K/V in bfloat16}``
and its decode attends over the cross cache in plain float32 PyTorch, as
the JAX package's einsums do).  The FFN of an attention block is the
dense MLP or, for a config with experts, the MoE layer, whose auxiliary
loss the block returns.  A spec with ``quant`` makes the ``attn`` caches
int8 (``quantize_kv``).  Segments (packed sequences) reach the
self-attention of ``attn``, ``attn_local`` and ``attn_cross``.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from .attention import (CacheSpec, _proj, _project_qkv, apply_rope,
                        attention_block_output, decode_attention,
                        flash_attention, init_attention, init_kv_cache,
                        quantize_kv)
from .common import rms_norm
from .mlp import apply_mlp, apply_moe, init_mlp, init_moe
from .recurrent import (apply_mamba, apply_rglru, init_mamba,
                        init_mamba_state, init_rglru, init_rglru_state)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_ffn(gen, cfg: ArchConfig, device, dtype):
    if cfg.num_experts:
        return {"moe": init_moe(gen, cfg.d_model, cfg.d_ff, cfg.num_experts,
                                shared_expert=cfg.shared_expert,
                                device=device, dtype=dtype)}
    return {"mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, device, dtype)}


def init_block(gen, cfg: ArchConfig, kind: str, device="cuda",
               dtype=torch.float32):
    d = cfg.d_model

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=device)

    if kind in ("attn", "attn_local", "attn_bidir", "attn_cross"):
        p = {
            "ln1": zeros(),
            "attn": init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim, cfg.qkv_bias, device,
                                   dtype),
            "ln2": zeros(),
        }
        if kind == "attn_cross":        # cross attention has no bias
            p["lnx"] = zeros()
            p["xattn"] = init_attention(gen, d, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim,
                                        False, device, dtype)
        p.update(_init_ffn(gen, cfg, device, dtype))
        return p
    if kind == "mamba":
        return {
            "ln1": zeros(),
            "mamba": init_mamba(gen, d, cfg.d_inner, cfg.ssm_state,
                                cfg.conv_width, device=device, dtype=dtype),
        }
    if kind == "rec":
        return {
            "ln1": zeros(),
            "rec": init_rglru(gen, d, cfg.d_inner,
                              cfg.rglru_heads or cfg.num_heads,
                              cfg.conv_width, device, dtype),
            "ln2": zeros(),
            "mlp": init_mlp(gen, d, cfg.d_ff, device, dtype),
        }
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# ffn and self-attention
# ---------------------------------------------------------------------------
def _apply_ffn(params, x, cfg: ArchConfig):
    """(y, aux): the MoE layer's output and router loss, or the MLP's
    output and 0."""
    if "moe" in params:
        return apply_moe(params["moe"], x, cfg.num_experts,
                         cfg.experts_per_tok, cfg.moe_mode,
                         cfg.capacity_factor)
    return apply_mlp(params["mlp"], x), 0.0


def _self_attention(params, x, cfg: ArchConfig, kind, positions,
                    segments=None):
    q, k, v = _project_qkv(params["attn"], x)
    q, k = apply_rope(q, k, cfg.rope, positions)
    window = cfg.window if kind == "attn_local" else None
    out = flash_attention(q, k, v, causal=kind != "attn_bidir",
                          window=window, segments=segments)
    return attention_block_output(params["attn"], out, x.dtype)


def _cross_attention(params, x, enc_out):
    """(x + the cross attention of x over ``enc_out``, its K and V):
    non-causal, no RoPE, no segments."""
    hx = rms_norm(x, params["lnx"])
    qx, kx, vx = _project_qkv(params["xattn"], hx, enc_out)
    xo = flash_attention(qx, kx, vx, causal=False)
    return x + attention_block_output(params["xattn"], xo, x.dtype), kx, vx


# ---------------------------------------------------------------------------
# train / prefill apply: returns (x, aux_loss, state_out)
# ---------------------------------------------------------------------------
def apply_block(params, x, kind: str, cfg: ArchConfig, ctx: dict):
    """Train / prefill apply: returns (x, aux_loss, state_out), state_out
    the block's recurrent state (None for attention)."""
    aux = 0.0
    state_out = None
    if kind in ("attn", "attn_local", "attn_bidir", "attn_cross"):
        h = rms_norm(x, params["ln1"])
        self_kind = "attn" if kind == "attn_cross" else kind
        x = x + _self_attention(params, h, cfg, self_kind, ctx["positions"],
                                ctx.get("segments"))
        if kind == "attn_cross":
            x, _, _ = _cross_attention(params, x, ctx["enc_out"])
        h2 = rms_norm(x, params["ln2"])
        y, aux = _apply_ffn(params, h2, cfg)
        x = x + y
    elif kind == "mamba":
        h = rms_norm(x, params["ln1"])
        y, state_out = apply_mamba(params["mamba"], h,
                                   state=ctx.get("rec_state"))
        x = x + y
    elif kind == "rec":
        h = rms_norm(x, params["ln1"])
        y, state_out = apply_rglru(params["rec"], h,
                                   state=ctx.get("rec_state"))
        x = x + y
        h2 = rms_norm(x, params["ln2"])
        x = x + apply_mlp(params["mlp"], h2)
    else:
        raise ValueError(kind)
    return x, aux, state_out


def prefill_block(params, x, kind: str, cfg: ArchConfig, ctx: dict):
    """Like apply_block but also materialises the decode cache: for
    ``attn_local`` the ring-buffered K/V of the last min(capacity,
    window) positions, for ``attn`` those of the spec's capacity and
    window, for ``attn_cross`` those of the spec's capacity (its
    self-attention ignores the spec's window, as in the JAX package) and
    the cross K/V in bfloat16, for a recurrent kind its final state."""
    if kind in ("attn", "attn_local", "attn_cross"):
        spec: CacheSpec = ctx["spec"]
        h = rms_norm(x, params["ln1"])
        q, k, v = _project_qkv(params["attn"], h)
        q, k = apply_rope(q, k, cfg.rope, ctx["positions"])
        if kind == "attn_local":
            window = cfg.window
            cache_spec = CacheSpec(min(spec.capacity, cfg.window),
                                   cfg.window)
        else:
            window = spec.window if kind == "attn" else None
            cache_spec = spec
        out = flash_attention(q, k, v, causal=True, window=window)
        x = x + attention_block_output(params["attn"], out, x.dtype)
        cache = _cache_from_kv(k, v, cache_spec)
        if kind == "attn_cross":
            x, kx, vx = _cross_attention(params, x, ctx["enc_out"])
            cache = {"self": cache,
                     "cross": {"k": kx.to(torch.bfloat16),
                               "v": vx.to(torch.bfloat16)}}
        h2 = rms_norm(x, params["ln2"])
        y, aux = _apply_ffn(params, h2, cfg)
        return x + y, aux, cache
    if kind in ("mamba", "rec"):
        return apply_block(params, x, kind, cfg, ctx)
    raise ValueError(kind)


def _cache_from_kv(k, v, spec: CacheSpec):
    """A ring-buffer cache holding the last ``capacity`` positions of a
    prefilled sequence, laid out so that slot = pos % capacity; K and V
    in bfloat16 whatever the model's type, as in the JAX package, or
    int8 with their scales when the spec quantizes (from K and V in the
    model's type, as the JAX package quantizes them)."""
    b, s, kh, hd = k.shape
    cap = spec.capacity
    dev = k.device
    if s < cap:
        pad = cap - s
        zeros = k.new_zeros((b, pad, kh, hd))
        kc = torch.cat([k, zeros], dim=1)
        vc = torch.cat([v, zeros.to(v.dtype)], dim=1)
        pos = torch.cat([torch.arange(s, dtype=torch.int32, device=dev),
                         torch.full((pad,), -1, dtype=torch.int32,
                                    device=dev)])
    else:
        tail = s - cap
        kc = torch.roll(k[:, tail:], shifts=tail % cap, dims=1)
        vc = torch.roll(v[:, tail:], shifts=tail % cap, dims=1)
        pos = torch.roll(torch.arange(tail, s, dtype=torch.int32,
                                      device=dev), shifts=tail % cap)
    if spec.quant:
        (k8, ks), (v8, vs) = quantize_kv(kc), quantize_kv(vc)
        return {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs, "pos": pos}
    return {"k": kc.to(torch.bfloat16), "v": vc.to(torch.bfloat16),
            "pos": pos}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_block(params, x, kind: str, cfg: ArchConfig, cache, ctx: dict):
    if kind in ("attn", "attn_local"):
        spec: CacheSpec = ctx["spec"]
        h = rms_norm(x, params["ln1"])
        s = CacheSpec(cache["k"].shape[1],
                      cfg.window if kind == "attn_local" else spec.window,
                      spec.quant)
        y, cache = decode_attention(params["attn"], h, cache, ctx["t"], s,
                                    rope=cfg.rope,
                                    positions=ctx.get("positions"))
        x = x + y
        h2 = rms_norm(x, params["ln2"])
        out, _ = _apply_ffn(params, h2, cfg)
        return x + out, cache
    if kind == "attn_cross":
        h = rms_norm(x, params["ln1"])
        y, self_cache = decode_attention(params["attn"], h, cache["self"],
                                         ctx["t"], ctx["spec"], rope=cfg.rope,
                                         positions=ctx.get("positions"))
        x = x + y
        x = x + _decode_cross(params["xattn"], rms_norm(x, params["lnx"]),
                              cache["cross"], cfg.head_dim)
        out, _ = _apply_ffn(params, rms_norm(x, params["ln2"]), cfg)
        return x + out, {"self": self_cache, "cross": cache["cross"]}
    if kind in ("mamba", "rec"):
        x, _, state = apply_block(params, x, kind, cfg,
                                  dict(ctx, rec_state=cache))
        return x, state
    raise ValueError(kind)


def _decode_cross(params, hx, cross, head_dim):
    """One query over the cross cache, in float32 as the JAX package's
    einsums: softmax(q k / sqrt(hd)) v, cast back to hx's type and
    projected by ``wo``."""
    b = hx.shape[0]
    qx = _proj(hx, params["wq"])
    kx, vx = cross["k"], cross["v"]
    kh = kx.shape[2]
    qh = qx.reshape(b, kh, qx.shape[2] // kh, head_dim)
    sc = torch.einsum("bkgh,btkh->bkgt", qh.float(), kx.float())
    p = torch.softmax(sc / math.sqrt(head_dim), dim=-1)
    xo = torch.einsum("bkgt,btkh->bkgh", p, vx.float())
    xo = xo.reshape(b, 1, qx.shape[2], head_dim).to(hx.dtype)
    return attention_block_output(params, xo, hx.dtype)


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------
def init_block_cache(cfg: ArchConfig, kind: str, batch: int,
                     spec: CacheSpec, dtype=torch.bfloat16, device="cuda",
                     enc_len: int = 0):
    """An empty decode cache of ``kind``; ``attn_cross`` holds zero cross
    K/V over ``enc_len`` encoder positions."""
    if kind in ("attn", "attn_local"):
        cap = min(spec.capacity, cfg.window) if kind == "attn_local" \
            else spec.capacity
        return init_kv_cache(batch, cap, cfg.num_kv_heads, cfg.head_dim,
                             dtype, quant=spec.quant, device=device)
    if kind == "attn_cross":
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        return {"self": init_kv_cache(batch, spec.capacity,
                                      cfg.num_kv_heads, cfg.head_dim, dtype,
                                      device=device),
                "cross": {name: torch.zeros(shape, dtype=dtype,
                                            device=device)
                          for name in ("k", "v")}}
    if kind == "mamba":
        return init_mamba_state(batch, cfg.d_inner, cfg.ssm_state,
                                cfg.conv_width, dtype, device)
    if kind == "rec":
        return init_rglru_state(batch, cfg.d_inner, cfg.conv_width, dtype,
                                device)
    raise ValueError(kind)
