"""Recurrent sequence mixers: the Mamba-1 selective SSM (falcon-mamba)
and the RG-LRU (recurrentgemma).

The selective scan always goes through ``kernels.mamba_scan.mamba_scan``:
the CUDA kernel on the card, for a prompt and for a decode step alike
(S = 1), and its plain version on the CPU.  The JAX package's chunked
``jnp`` scan and its ``kernel_dispatch`` switch have no counterpart.

The RG-LRU (RecurrentGemma / Griffin) block runs its linear recurrence
through ``kernels.rglru_scan.rglru_scan`` the same way, on every path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import mamba_scan
from ..kernels.rglru_scan import rglru_scan
from .common import dense_init, silu


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)).
    ``torch.nn.functional.softplus`` returns x itself above its threshold
    of 20, which is not the same function bit for bit."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


# ---------------------------------------------------------------------------
# causal depthwise conv1d (width w)
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, b=None, state=None):
    """x: (B,S,D); w: (W,D) depthwise taps; state: (B,W-1,D) trailing
    context from the previous chunk (None = zeros: sequence start).
    Returns (y, new_state).  The taps are summed in order i = 0..W-1,
    then the bias is added, as the JAX package sums them."""
    bsz, s, d = x.shape
    width = w.shape[0]
    if state is None:
        state = torch.zeros((bsz, width - 1, d), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                   # (B, S+W-1, D)
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xp[:, i:i + s, :] * w[i].to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return y, new_state


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba): selective SSM
# ---------------------------------------------------------------------------
def init_mamba(gen, d_model, d_inner, d_state, conv_width=4, dt_rank=None,
               device="cuda", dtype=torch.float32):
    """The JAX package's leaves, shapes and initial distributions, drawn
    in float32 from ``gen`` and cast to ``dtype``."""
    dt_rank = dt_rank or max(1, d_model // 16)

    def dense(shape, in_axes=(0,)):
        return dense_init(gen, shape, in_axes, dtype, device)

    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((d_inner,), generator=gen, **f32)
    a_log = torch.log(torch.arange(1, d_state + 1, **f32)
                      .expand(d_inner, d_state))
    return {
        "in_proj": dense((d_model, 2 * d_inner)),
        "conv_w": dense((conv_width, d_inner)),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": dense((d_inner, dt_rank + 2 * d_state)),
        "dt_proj": dense((dt_rank, d_inner)),
        "dt_bias": torch.log(torch.expm1(torch.clamp_min(u * 0.1, 1e-3)))
        .to(dtype),
        "A_log": a_log.to(dtype),
        "D": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": dense((d_inner, d_model)),
    }


def apply_mamba(params, x, state=None):
    """x: (B,S,d_model).  state: dict(conv, ssm) or None.  Returns
    (y, new_state).  The scan computes in float32, as the JAX package's
    kernel path does: it takes xc, B and C in the model's dtype (B and C
    as column slices of the projection, no copy) and widens them itself,
    exactly; delta, A and the ``ssm`` state are float32."""
    dt_ = x.dtype
    d_inner = params["dt_proj"].shape[1]
    n = params["A_log"].shape[1]
    xz = x @ params["in_proj"].to(dt_)
    xin, z = torch.chunk(xz, 2, dim=-1)
    conv_state = None if state is None else state["conv"]
    xc, conv_state = causal_conv1d(xin, params["conv_w"], params["conv_b"],
                                   conv_state)
    xc = silu(xc)

    dt_rank = params["dt_proj"].shape[0]
    proj = xc @ params["x_proj"].to(dt_)
    dt_raw, b_, c_ = torch.split(proj, [dt_rank, n, n], dim=-1)
    delta = softplus((dt_raw @ params["dt_proj"].to(dt_)).float()
                     + params["dt_bias"])                    # (B,S,Di) f32
    a_mat = -torch.exp(params["A_log"])                      # (Di,N)

    ssm0 = (torch.zeros((x.shape[0], d_inner, n), dtype=torch.float32,
                        device=x.device)
            if state is None else state["ssm"])
    y_f, ssm_last = mamba_scan(xc, delta, b_, c_,
                               a_mat.float().contiguous(), ssm0.contiguous())
    y = y_f.to(dt_)
    y = y + xc * params["D"].to(dt_)
    y = y * silu(z)
    out = y @ params["out_proj"].to(dt_)
    return out, {"conv": conv_state, "ssm": ssm_last}


def init_mamba_state(batch, d_inner, d_state, conv_width,
                     dtype=torch.bfloat16, device="cuda"):
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin) recurrent block
# ---------------------------------------------------------------------------
def init_rglru(gen, d_model, d_inner, num_heads, conv_width=4,
               device="cuda", dtype=torch.float32):
    """Griffin recurrent block: x-branch (conv1d -> RG-LRU), gate branch
    (GeLU), merged and projected out.  The recurrence and input gates are
    block-diagonal with ``num_heads`` blocks.  The JAX package's leaves,
    shapes and initial distributions, drawn in float32 and cast to
    ``dtype``."""
    bd = d_inner // num_heads

    def dense(shape, in_axes=(0,)):
        return dense_init(gen, shape, in_axes, dtype, device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    lin = torch.linspace(2.0, 6.0, d_inner, dtype=torch.float32,
                         device=device)
    return {
        "in_x": dense((d_model, d_inner)),
        "in_gate": dense((d_model, d_inner)),
        "conv_w": dense((conv_width, d_inner)),
        "conv_b": zeros((d_inner,)),
        "w_a": dense((num_heads, bd, bd), in_axes=(1,)),
        "b_a": zeros((num_heads, bd)),
        "w_i": dense((num_heads, bd, bd), in_axes=(1,)),
        "b_i": zeros((num_heads, bd)),
        # a = sigmoid(lam)^(c*r); sigmoid(lam) from about 0.86 to 0.998
        "lam": torch.log(torch.exp(lin) - 1.0).to(dtype),
        "out": dense((d_inner, d_model)),
    }


def apply_rglru(params, x, state=None, c_const=8.0):
    """x: (B,S,d_model); state: dict(conv, h) or None -> (y, new_state).

    The gate is ``jax.nn.gelu``'s default, the tanh approximation.  The
    scan takes float32 a, beta*i*x and h, as the JAX package's kernel path
    does, and always goes through ``kernels.rglru_scan.rglru_scan`` (the
    CUDA kernel on the card, for a prompt and for a decode step alike);
    the states come back float32 and are cast to x's type for the output.
    """
    dt_ = x.dtype
    bsz, s, _ = x.shape
    d_inner = params["in_x"].shape[1]
    nh, bd, _ = params["w_a"].shape

    gate = F.gelu(x @ params["in_gate"].to(dt_), approximate="tanh")
    xin = x @ params["in_x"].to(dt_)
    conv_state = None if state is None else state["conv"]
    xc, conv_state = causal_conv1d(xin, params["conv_w"], params["conv_b"],
                                   conv_state)

    xh = xc.reshape(bsz, s, nh, bd)
    r = torch.sigmoid(torch.einsum("bshd,hde->bshe", xh,
                                   params["w_a"].to(dt_))
                      + params["b_a"].to(dt_)).float()
    i = torch.sigmoid(torch.einsum("bshd,hde->bshe", xh,
                                   params["w_i"].to(dt_))
                      + params["b_i"].to(dt_)).float()
    r = r.reshape(bsz, s, d_inner)
    i = i.reshape(bsz, s, d_inner)
    log_a_base = F.logsigmoid(params["lam"])                  # (Di,) < 0
    log_a = c_const * r * log_a_base                          # (B,S,Di) f32
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    gx = beta * i * xc.float()

    h0 = (torch.zeros((bsz, d_inner), dtype=torch.float32, device=x.device)
          if state is None else state["h"])
    h_all, h_last = rglru_scan(a.contiguous(), gx.contiguous(),
                               h0.contiguous())
    y = h_all.to(dt_) * gate
    out = y @ params["out"].to(dt_)
    return out, {"conv": conv_state, "h": h_last}


def init_rglru_state(batch, d_inner, conv_width, dtype=torch.bfloat16,
                     device="cuda"):
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_inner), dtype=torch.float32,
                         device=device),
    }
