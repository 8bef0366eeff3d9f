"""Residual blocks by kind and their decode caches.

Only kind ``mamba`` (falcon-mamba's standalone Mamba-1 block) is ported.
The other kinds of the JAX package raise ``NotImplementedError`` naming
the ROADMAP item that brings them.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .attention import CacheSpec
from .common import rms_norm
from .recurrent import apply_mamba, init_mamba, init_mamba_state

TODO = {
    "attn": "ROADMAP A7: the dense family (attention.py, mlp.py, RoPE)",
    "attn_local": "ROADMAP A7: recurrentgemma serve (local attention, "
                  "RoPE, mlp.py) and B7",
    "attn_bidir": "ROADMAP A7: the enc-dec family",
    "attn_cross": "ROADMAP A7: the enc-dec family",
    "rec": "ROADMAP A7: recurrentgemma serve (rglru, mlp.py) and B6",
}


def _unported(kind: str):
    if kind in TODO:
        return NotImplementedError(f"block kind {kind!r} is not ported "
                                   f"yet: {TODO[kind]}")
    return ValueError(kind)


def init_block(gen, cfg: ArchConfig, kind: str, device="cuda",
               dtype=torch.float32):
    if kind == "mamba":
        return {
            "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "mamba": init_mamba(gen, cfg.d_model, cfg.d_inner,
                                cfg.ssm_state, cfg.conv_width,
                                device=device, dtype=dtype),
        }
    raise _unported(kind)


def apply_block(params, x, kind: str, cfg: ArchConfig, ctx: dict):
    """Train / prefill apply: returns (x, aux_loss, state_out), state_out
    the block's recurrent state."""
    if kind == "mamba":
        h = rms_norm(x, params["ln1"])
        y, state_out = apply_mamba(params["mamba"], h,
                                   state=ctx.get("rec_state"))
        return x + y, 0.0, state_out
    raise _unported(kind)


def prefill_block(params, x, kind: str, cfg: ArchConfig, ctx: dict):
    """Like apply_block; for a recurrent kind the cache IS the state."""
    return apply_block(params, x, kind, cfg, ctx)


def decode_block(params, x, kind: str, cfg: ArchConfig, cache, ctx: dict):
    if kind == "mamba":
        x, _, state = apply_block(params, x, kind, cfg,
                                  dict(ctx, rec_state=cache))
        return x, state
    raise _unported(kind)


def init_block_cache(cfg: ArchConfig, kind: str, batch: int,
                     spec: CacheSpec, dtype=torch.bfloat16, device="cuda"):
    if kind == "mamba":
        return init_mamba_state(batch, cfg.d_inner, cfg.ssm_state,
                                cfg.conv_width, dtype, device)
    raise _unported(kind)
