"""Feed-forward layers: the dense SwiGLU MLP and the Mixture-of-Experts.

Two MoE execution modes, as in the JAX package (selected per config by
``moe_mode``):

* ``dispatch``: GShard/Switch capacity-based dispatch and combine over
  small token groups (``min(256, S)`` tokens; a ragged S is one group of
  S), a fixed capacity per expert and group, and tokens over capacity
  dropped (they contribute zero);
* ``dense_all``: every expert runs on every token, combined with the
  sparse top-k weights; nothing drops.

Both return the router's auxiliary loss (Switch load balance on the
first slot plus 1e-3 times the z-loss).  The expert products are plain
``torch.einsum``: the JAX package computes them with ``jnp.einsum``,
outside any Pallas kernel.  One-hots are comparisons against an
``arange`` (``F.one_hot`` refuses the out-of-range positions that the
JAX one-hot maps to zeros, and may read its indices on the host).
"""
from __future__ import annotations

import torch

from .common import dense_init, silu


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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def init_moe(gen, d_model, d_ff, num_experts, shared_expert=False,
             shared_d_ff=None, device="cuda", dtype=torch.float32):
    """router (d, E); experts (E, d, ff), (E, d, ff) and (E, ff, d), each
    Normal(0, 1/fan_in) over its axis 1; an optional shared MLP.  Each
    expert leaf is drawn in float32 and cast to ``dtype``."""
    def dense(shape, in_axes=(0,)):
        return dense_init(gen, shape, in_axes, dtype, device)

    p = {
        "router": dense((d_model, num_experts)),
        "w_gate": dense((num_experts, d_model, d_ff), (1,)),
        "w_up": dense((num_experts, d_model, d_ff), (1,)),
        "w_down": dense((num_experts, d_ff, d_model), (1,)),
    }
    if shared_expert:
        p["shared"] = init_mlp(gen, d_model, shared_d_ff or d_ff, device,
                               dtype)
    return p


def _one_hot(idx, n, dtype):
    """(..., n): 1 where the last axis equals ``idx``, zeros everywhere
    for an index outside [0, n) (as ``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _router(params, x, num_experts, top_k):
    """float32 logits, softmax, the top-k probabilities (sorted
    descending) renormalised to sum 1; aux = E * sum(mean prob * share of
    first choices) + 1e-3 * mean(logsumexp(logits)^2)."""
    logits = x.float() @ params["router"].float()          # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp_min(torch.sum(top_p, -1, keepdim=True),
                                    1e-9)
    me = torch.mean(probs.reshape(-1, num_experts), dim=0)
    ce = torch.mean(_one_hot(top_i[..., 0], num_experts, torch.float32)
                    .reshape(-1, num_experts), dim=0)
    lb_loss = num_experts * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return top_p, top_i, lb_loss + 1e-3 * z_loss


def apply_moe_dense_all(params, x, num_experts, top_k):
    """Every expert on every token, combined with the sparse top-k
    weights (zero outside the top k)."""
    dt = x.dtype
    top_p, top_i, aux = _router(params, x, num_experts, top_k)
    w = torch.sum(_one_hot(top_i, num_experts, dt)
                  * top_p[..., None].to(dt), dim=-2)          # (B,S,E)
    h = torch.einsum("bsd,edf->bsef", x, params["w_gate"].to(dt))
    u = torch.einsum("bsd,edf->bsef", x, params["w_up"].to(dt))
    y = torch.einsum("bsef,efd->bsed", silu(h) * u, params["w_down"].to(dt))
    out = torch.einsum("bsed,bse->bsd", y, w)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], x)
    return out, aux


def moe_capacity(seq_len: int, num_experts: int, top_k: int,
                 capacity_factor: float,
                 group_size: int = 256) -> tuple[int, int, int]:
    """(group size, groups a row, capacity) of ``apply_moe_dispatch``:
    groups of ``min(group_size, S)`` tokens, or one group of S when it
    does not divide S; the capacity an expert a group is
    ``max(1, round(g * top_k / E * capacity_factor))`` with Python's
    ``round`` (half to even), on the host, as the JAX package computes
    it."""
    g = min(group_size, seq_len)
    ng = seq_len // g
    if seq_len % g:                               # ragged tail: one group
        g, ng = seq_len, 1
    cap = int(max(1, round(g * top_k / num_experts * capacity_factor)))
    return g, ng, cap


def dispatch_tensors(top_p, top_i, num_experts, cap, dt):
    """(dispatch (G,g,E,C) in ``dt``, combine (G,g,E,C) float32) from the
    routes of G groups of g tokens, built slot by slot: a token's slot-s
    choice takes the next free place of its expert in its group (the
    running ``fill`` of the slots before, then the tokens before it in
    this slot), and is dropped when that place is at or past ``cap``."""
    G, g, top_k = top_i.shape
    dispatch = torch.zeros((G, g, num_experts, cap), dtype=dt,
                           device=top_i.device)
    combine = torch.zeros((G, g, num_experts, cap), dtype=torch.float32,
                          device=top_i.device)
    fill = torch.zeros((G, num_experts), dtype=torch.long,
                       device=top_i.device)          # tokens assigned so far
    for slot in range(top_k):
        onehot = _one_hot(top_i[..., slot], num_experts, torch.long)
        pos_in_e = fill[:, None, :] + torch.cumsum(onehot, dim=1) - onehot
        pos = torch.sum(onehot * pos_in_e, dim=-1)               # (G,g)
        keep = pos < cap
        disp = (onehot.to(dt)[..., :, None]
                * _one_hot(pos, cap, dt)[..., None, :]
                * keep[..., None, None].to(dt))                  # (G,g,E,C)
        dispatch = dispatch + disp
        combine = combine + disp.float() * top_p[..., slot][..., None, None]
        fill = fill + torch.sum(onehot * keep[..., None].long(), dim=1)
    return dispatch, combine


def apply_moe_dispatch(params, x, num_experts, top_k,
                       capacity_factor: float = 1.25,
                       group_size: int = 256):
    """GShard dispatch/combine over small token groups with a fixed
    capacity an expert a group (``moe_capacity``); tokens over capacity
    are dropped.  x: (B,S,d).  ``dispatch`` is in x's type, ``combine``
    float32, cast to x's type for the final product."""
    dt = x.dtype
    b, s, d = x.shape
    e = num_experts
    g, ng, cap = moe_capacity(s, e, top_k, capacity_factor, group_size)
    top_p, top_i, aux = _router(params, x, e, top_k)
    xg = x.reshape(b * ng, g, d)
    dispatch, combine = dispatch_tensors(
        top_p.reshape(b * ng, g, top_k), top_i.reshape(b * ng, g, top_k),
        e, cap, dt)
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)            # (G,E,C,d)
    h = torch.einsum("gecd,edf->gecf", xe, params["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", xe, params["w_up"].to(dt))
    ye = torch.einsum("gecf,efd->gecd", silu(h) * u, params["w_down"].to(dt))
    out = torch.einsum("gsec,gecd->gsd", combine.to(dt), ye)
    out = out.reshape(b, s, d)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], x)
    return out, aux


def apply_moe(params, x, num_experts, top_k, mode="dispatch",
              capacity_factor: float = 1.25):
    if mode == "dense_all":
        return apply_moe_dense_all(params, x, num_experts, top_k)
    return apply_moe_dispatch(params, x, num_experts, top_k, capacity_factor)
