"""Plain PyTorch version of the batched flat master update.

One call applies k coalesced worker messages IN ORDER to the flat master
state.  The update rule is the family-shared per-worker-momentum shape
(paper Alg. 4/6/8/9 + the Nadam extension), widened to the
delay-compensated members (Alg. 7/10) via a per-worker ``sent`` snapshot
slab, to moving learning-rate schedules via per-message scalars, and to
the whole send family via per-message hat coefficients + optional
weights:

    delta  = theta - sent_i                      [sent slab only]
    ghat   = g_j + lam * (g_j^2 (.) delta)       [delay compensation]
    v_i'   = gamma_j * v_i + cg_j * (ghat / s_j) (momentum, stored scale)
    u2'    = b2 * u2 + (1 - b2) * ghat^2         [adaptive only]
    den    = sqrt(u2') + eps                     [adaptive only; else 1]
    num    = (gamma_j * s_j) * v_i' + cg_j*ghat  [nesterov]  else  v_i'
    theta' = theta - lr_j * s_j^? * num / den    (s_j only for heavy-ball)
    v0'    = v0 - v_i + v_i'                     [track_v0: O(k) sum]
    hat_j  =                                     [by hat_mode]
        theta'                                            ["theta"]
        theta' - hc_j * v0' [/ den]                       ["v0"]
        theta' - hc_j * v_i'                              ["self": lwp]
        theta' - hc_j * sum_m w_jm v_m'                   ["weighted"]
    sent_i'= hat_j (dana-dc) or theta' (dc-asgd) [sent slab only]

with (per message j) worker id i = ids[j], update rate lr_j, momentum
gamma_j, gradient coefficient cg_j, momentum-correction scale
s_j = vscales[j] and hat coefficient hc_j (``FlatAlgorithm._msg_scalars``
composes them).  A worker appearing twice in one batch sees its own first
update.

This is the oracle the CUDA kernel (``kernel.py``) is held against, and
the route ``ops.flat_master_update_batch`` takes for CPU tensors.  Its
expressions are the JAX reference's, operation for operation (each a*b+c
rounded twice), so on the CPU it equals the un-jitted JAX reference bit
for bit for the elementwise family; the weighted hat's tensordot sums in
another order and agrees to f32 tolerance.

Like the kernel, it updates the state IN PLACE: theta, v, v0, u2 and
sent are overwritten and returned.  The gap-aware branch waits for its
slice (ROADMAP.md, kernel B3).
"""
from __future__ import annotations

import numpy as np
import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt.  PyTorch's CPU ``torch.sqrt`` is one
    bit off on some f32 inputs; the double route rounds once."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def default_hat_coefs(lrs_next, gammas, vscales, *, adaptive: bool):
    """The v0 look-ahead scale lr(t+j+1)*gamma [*vscale] for callers that
    do not pass explicit ``hcs`` (``FlatAlgorithm`` always does)."""
    return (lrs_next * gammas if adaptive
            else (lrs_next * gammas) * vscales)


def _host_f32(x):
    return np.asarray(x, np.float32)


def flat_master_update_batch_ref(theta, v, v0, u2, sent, avg_step, g, ids,
                                 lrs, lrs_next, gammas, cgs, vscales, *,
                                 nesterov: bool, b2: float = 0.999,
                                 eps: float = 1e-8,
                                 dc_lambda: float | None = None,
                                 sent_view: bool = False,
                                 gap_aware: bool = False,
                                 gap_ema: float = 0.99,
                                 n_elems: int = 0,
                                 telemetry: bool = False,
                                 hat_mode: str | None = None,
                                 hcs=None, weights=None):
    """theta (R,128); v (N,R,128); v0/u2 (R,128) or None; sent (N,R,128)
    or None; g (k,R,128); ids (k,) ints; lrs/lrs_next/gammas/cgs/vscales
    (k,) host f32; hcs (k,) host f32 hat coefficients or None; weights
    (k, N) host f32 weights (hat_mode "weighted" only).  The argument
    list is the JAX reference's (avg_step, gap_ema and n_elems belong to
    the gap-aware branch).

    Returns (theta', v', v0', u2', sent', avg_step, hats (k,R,128),
    thetas_pre or None); the state tensors are the inputs, updated in
    place.
    """
    if gap_aware:
        raise NotImplementedError(
            "the gap-aware update (ga-asgd) is not ported yet: ROADMAP.md "
            "kernel B3")
    k = g.shape[0]
    track_v0 = v0 is not None
    adaptive = u2 is not None
    if hat_mode is None:
        hat_mode = "v0" if track_v0 else "theta"
    ids = np.asarray(ids)
    lrs, gammas, cgs, vscales = map(_host_f32, (lrs, gammas, cgs, vscales))
    if hcs is None:
        hcs = default_hat_coefs(_host_f32(lrs_next), gammas, vscales,
                                adaptive=adaptive)
    hcs = _host_f32(hcs)
    if hat_mode == "weighted":
        weights = torch.as_tensor(_host_f32(weights), device=v.device)
    theta_in, v0_in, u2_in = theta, v0, u2
    hats, pres = [], []
    for j in range(k):
        i = int(ids[j])
        lr = lrs[j]
        gamma, cg, vs, hc = gammas[j], cgs[j], vscales[j], hcs[j]
        if telemetry:
            pres.append(theta)
        vi = v[i].clone()              # v[i] is a view: copy before v[i] =
        gj = g[j]
        if sent is not None:
            delta = theta - sent[i]
            if dc_lambda is not None:
                # mirror DCASGD/DanaDC: grad + lam*((g*g)*delta)
                gj = gj + dc_lambda * ((gj * gj) * delta)
        # stored scale: v holds v_true / vscale
        v_new = gamma * vi + cg * ((np.float32(1.0) / vs) * gj)
        if adaptive:
            u2 = b2 * u2 + (1 - b2) * gj * gj
            denom = sqrt_rn(u2) + eps
        if nesterov:
            num = (gamma * vs) * v_new + cg * gj
            if adaptive:
                theta = (-lr) * (num / denom) + theta
            else:
                theta = (-lr) * num + theta
        else:
            if adaptive:
                theta = ((-lr) * vs) * (v_new / denom) + theta
            else:
                theta = ((-lr) * vs) * v_new + theta
        v[i] = v_new
        if track_v0:
            v0 = (v0 - vi) + v_new
        if hat_mode == "theta":
            hat = theta
        elif hat_mode == "v0":
            if adaptive:
                hat = theta - (hc * v0) / denom
            else:
                hat = (-hc) * v0 + theta          # mirror DanaZero.send
        elif hat_mode == "self":
            hat = (-hc) * v_new + theta           # mirror LWP.send
        elif hat_mode == "weighted":
            wsum = torch.tensordot(weights[j], v, dims=1)
            hat = (-hc) * wsum + theta
        else:
            raise ValueError(f"unknown hat_mode {hat_mode!r}")
        if sent is not None:
            sent[i] = hat if sent_view else theta
        hats.append(hat)
    hats = torch.stack(hats)
    pres = torch.stack(pres) if telemetry else None
    # in place, like the kernel (and the donated JAX pass)
    theta_in.copy_(theta)
    if track_v0:
        v0_in.copy_(v0)
    if adaptive:
        u2_in.copy_(u2)
    return theta_in, v, v0_in, u2_in, sent, avg_step, hats, pres
