"""Residual blocks by kind and their decode caches.

Ported kinds: ``mamba`` (falcon-mamba's standalone Mamba-1 block),
recurrentgemma's ``rec`` (RG-LRU + MLP) and ``attn_local`` (sliding-window
attention + MLP), and the decoder-only families' ``attn`` (full causal
attention + FFN: ``swa_attention`` with a window of S, a cache of the
spec's full capacity, or its window where the spec sets one).  The FFN
of an attention block is the dense MLP or, for a config with experts,
the MoE layer, whose auxiliary loss the block returns.  A spec with
``quant`` makes the ``attn`` caches int8 (``quantize_kv``).  The enc-dec
kinds ``attn_bidir`` and ``attn_cross`` raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .attention import (CacheSpec, _project_qkv, apply_rope,
                        attention_block_output, decode_attention,
                        flash_attention, init_attention, init_kv_cache,
                        quantize_kv)
from .common import rms_norm
from .mlp import apply_mlp, apply_moe, init_mlp, init_moe
from .recurrent import (apply_mamba, apply_rglru, init_mamba,
                        init_mamba_state, init_rglru, init_rglru_state)

TODO = {
    "attn_bidir": "ROADMAP A7(d)(iv): the enc-dec family",
    "attn_cross": "ROADMAP A7(d)(iv): the enc-dec family",
}


def _unported(kind: str):
    if kind in TODO:
        return NotImplementedError(f"block kind {kind!r} is not ported "
                                   f"yet: {TODO[kind]}")
    return ValueError(kind)


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

    if kind in ("attn", "attn_local"):
        p = {
            "ln1": zeros(),
            "attn": init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim, cfg.qkv_bias, device,
                                   dtype),
            "ln2": zeros(),
        }
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
    raise _unported(kind)


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
    if kind not in ("attn", "attn_local"):
        raise _unported(kind)
    q, k, v = _project_qkv(params["attn"], x)
    q, k = apply_rope(q, k, cfg.rope, positions)
    window = cfg.window if kind == "attn_local" else None
    out = flash_attention(q, k, v, causal=True, window=window,
                          segments=segments)
    return attention_block_output(params["attn"], out, x.dtype)


# ---------------------------------------------------------------------------
# train / prefill apply: returns (x, aux_loss, state_out)
# ---------------------------------------------------------------------------
def apply_block(params, x, kind: str, cfg: ArchConfig, ctx: dict):
    """Train / prefill apply: returns (x, aux_loss, state_out), state_out
    the block's recurrent state (None for attention)."""
    aux = 0.0
    state_out = None
    if kind in ("attn", "attn_local"):
        h = rms_norm(x, params["ln1"])
        x = x + _self_attention(params, h, cfg, kind, ctx["positions"],
                                ctx.get("segments"))
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
        raise _unported(kind)
    return x, aux, state_out


def prefill_block(params, x, kind: str, cfg: ArchConfig, ctx: dict):
    """Like apply_block but also materialises the decode cache: for
    ``attn_local`` the ring-buffered K/V of the last min(capacity,
    window) positions, for ``attn`` those of the spec's capacity and
    window, for a recurrent kind its final state."""
    if kind in ("attn", "attn_local"):
        spec: CacheSpec = ctx["spec"]
        h = rms_norm(x, params["ln1"])
        q, k, v = _project_qkv(params["attn"], h)
        q, k = apply_rope(q, k, cfg.rope, ctx["positions"])
        if kind == "attn_local":
            window = cfg.window
            cache_spec = CacheSpec(min(spec.capacity, cfg.window),
                                   cfg.window)
        else:
            window, cache_spec = spec.window, spec
        out = flash_attention(q, k, v, causal=True, window=window)
        x = x + attention_block_output(params["attn"], out, x.dtype)
        cache = _cache_from_kv(k, v, cache_spec)
        h2 = rms_norm(x, params["ln2"])
        y, aux = _apply_ffn(params, h2, cfg)
        return x + y, aux, cache
    if kind in ("mamba", "rec"):
        return apply_block(params, x, kind, cfg, ctx)
    raise _unported(kind)


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
    if kind in ("mamba", "rec"):
        x, _, state = apply_block(params, x, kind, cfg,
                                  dict(ctx, rec_state=cache))
        return x, state
    raise _unported(kind)


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------
def init_block_cache(cfg: ArchConfig, kind: str, batch: int,
                     spec: CacheSpec, dtype=torch.bfloat16, device="cuda"):
    if kind in ("attn", "attn_local"):
        cap = min(spec.capacity, cfg.window) if kind == "attn_local" \
            else spec.capacity
        return init_kv_cache(batch, cap, cfg.num_kv_heads, cfg.head_dim,
                             dtype, quant=spec.quant, device=device)
    if kind == "mamba":
        return init_mamba_state(batch, cfg.d_inner, cfg.ssm_state,
                                cfg.conv_width, dtype, device)
    if kind == "rec":
        return init_rglru_state(batch, cfg.d_inner, cfg.conv_width, dtype,
                                device)
    raise _unported(kind)
