"""Public wrapper: the fused DANA-Zero master round over arbitrary trees.

One launch per leaf, as the JAX package's ops run one kernel per leaf:
the CUDA kernel for CUDA tensors (or an error), the plain version for
CPU tensors.  The TPU's padding of every leaf to whole (R, 128) rows is
not needed: the kernel takes a contiguous leaf of any length.
"""
from __future__ import annotations

from ...core.types import flatten_up_to, tree_flatten, tree_unflatten
from .kernel import dana_master_update_cuda
from .ref import dana_master_update_ref


def dana_master_update_leaf(theta, v_i, v0, g, lr, gamma):
    """Single-array fused update; returns (theta', v_i', v0', theta_hat)."""
    if theta.device.type == "cuda":
        return dana_master_update_cuda(theta, v_i, v0, g, lr, gamma)
    if theta.device.type == "cpu":
        return dana_master_update_ref(theta, v_i, v0, g, lr, gamma)
    raise ValueError(f"no dana_master_update for device {theta.device}")


def dana_master_update(theta, v_i, v0, g, lr, gamma):
    """Tree version of the fused DANA-Zero master round."""
    leaves_t, treedef = tree_flatten(theta)
    others = [flatten_up_to(treedef, x) for x in (v_i, v0, g)]
    outs = [dana_master_update_leaf(t, vi, s0, gl, lr, gamma)
            for t, vi, s0, gl in zip(leaves_t, *others)]
    return tuple(tree_unflatten(treedef, [o[j] for o in outs])
                 for j in range(4))
