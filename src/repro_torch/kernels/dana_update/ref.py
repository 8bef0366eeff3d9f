"""Plain PyTorch version of the fused DANA-Zero master round (Alg. 4 +
App. A.2), the oracle of the CUDA kernel ``dana_master_update``.

Given worker i's gradient g and the master state (theta, v_i, v0):

    v_i' = gamma * v_i + g                  (momentum update, Eq. 10)
    v0'  = v0 - v_i + v_i'                  (O(k) running sum, App. A.2)
    th'  = theta - lr * v_i'                (master weight update)
    hat  = th' - lr * gamma * v0'           (look-ahead sent to the worker)

The scalars are values of the leaf's type, as the JAX reference makes
them (``jnp.asarray(lr, dtype)``), and ``lr * gamma`` is ONE product in
that type formed before it meets ``v0'``: a Python-float ``lr * gamma``
rounds differently.  ``host_scalars`` forms them on the host, for this
plain version and for the kernel's wrapper alike.  Each operation rounds
once in the leaf's type (float32 or bfloat16), as eager PyTorch rounds
it, so on the CPU a float32 leaf equals the eager JAX reference bit for
bit.
"""
from __future__ import annotations

import numpy as np
import torch

DTYPES = (torch.float32, torch.bfloat16)


def host_scalars(lr, gamma, dtype):
    """(lr, gamma, lr*gamma) as values of ``dtype``: np.float32 for a
    float32 leaf, bfloat16-rounded Python floats for a bfloat16 leaf."""
    if dtype == torch.float32:
        lr, gamma = np.float32(lr), np.float32(gamma)
        return lr, gamma, lr * gamma
    if dtype == torch.bfloat16:
        lr_b, gamma_b = torch.tensor(
            [float(lr), float(gamma)], dtype=torch.float32).to(dtype)
        return float(lr_b), float(gamma_b), float(lr_b * gamma_b)
    raise TypeError(f"dana_master_update takes {DTYPES}, got {dtype}")


def dana_master_update_ref(theta, v_i, v0, g, lr, gamma):
    lr, gamma, lrg = host_scalars(lr, gamma, theta.dtype)
    v_new = gamma * v_i + g
    v0_new = (v0 - v_i) + v_new
    theta_new = theta - lr * v_new
    theta_hat = theta_new - lrg * v0_new
    return theta_new, v_new, v0_new, theta_hat
