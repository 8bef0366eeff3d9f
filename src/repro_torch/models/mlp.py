"""Feed-forward layers: the dense SwiGLU MLP.

The JAX package's Mixture-of-Experts (``init_moe``, ``apply_moe``, both
dispatch modes) waits for the MoE family (ROADMAP A7(d)) and raises.
"""
from __future__ import annotations

import torch

from .common import dense_init, silu

MOE_TODO = ("the Mixture-of-Experts layer is not ported yet: ROADMAP "
            "A7(d), the MoE family")


def init_mlp(gen, d_model, d_ff, device="cuda", dtype=torch.float32):
    def dense(shape):
        return dense_init(gen, shape, (0,), dtype, device)
    return {
        "w_gate": dense((d_model, d_ff)),
        "w_up": dense((d_model, d_ff)),
        "w_down": dense((d_ff, d_model)),
    }


def apply_mlp(params, x):
    """silu(x W_gate) * (x W_up), then W_down, in x's type."""
    dt = x.dtype
    h = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    return (silu(h) * u) @ params["w_down"].to(dt)


def init_moe(*args, **kwargs):
    raise NotImplementedError(MOE_TODO)


def apply_moe(*args, **kwargs):
    raise NotImplementedError(MOE_TODO)
