"""Tree utilities over nested dicts / lists / tuples of tensors.

The flat layout (``core/flat.py``) and every parity test rest on ONE leaf
order, and it is the JAX package's: ``jax.tree.flatten`` visits dict
keys in SORTED order, lists and tuples in position order, and treats
``None`` as an empty subtree.  An MLP layer ``{"w", "b"}`` therefore
flattens as ``[b, w]``.  ``tree_flatten`` below reproduces that order, so
a tree packed here and the same tree packed by the JAX ``FlatSpec`` give
the same buffer.

Scalars that the algorithms carry beside the tensors (the step ``t``, the
previous learning rate, the lazy momentum-correction ``vscale``) live on
the host as Python ints / ``np.float32``: every per-message scalar is
computed on the host in float32, so the engine loop never waits on the
device for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

Pytree = Any

_LEAF = None          # treedef marker of a leaf


def _flatten(x, leaves: list):
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_flatten(x[k], leaves) for k in keys))
    if isinstance(x, (list, tuple)):
        return (type(x), None, tuple(_flatten(c, leaves) for c in x))
    if x is None:
        return ("none", None, ())
    leaves.append(x)
    return _LEAF


def tree_flatten(tree: Pytree):
    """(leaves, treedef) in JAX's flatten order (sorted dict keys).

    The recursion is a module-level function, not a closure over the
    leaves: a recursive closure is a reference cycle, and it would keep
    every leaf tensor alive until the cyclic garbage collector ran."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def _unflatten(d, it):
    if d is _LEAF:
        return next(it)
    kind, keys, children = d
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(keys, children)}
    if kind == "none":
        return None
    return kind(_unflatten(c, it) for c in children)


def tree_unflatten(treedef, leaves) -> Pytree:
    return _unflatten(treedef, iter(leaves))


def tree_leaves(tree: Pytree) -> list:
    return tree_flatten(tree)[0]


def flatten_up_to(treedef, tree: Pytree) -> list:
    """Leaves of ``tree``, which must have structure ``treedef``."""
    leaves, td = tree_flatten(tree)
    if td != treedef:
        raise ValueError("tree structure does not match the layout's")
    return leaves


def tree_map(f: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    leaves, treedef = tree_flatten(tree)
    others = [flatten_up_to(treedef, r) for r in rest]
    return tree_unflatten(treedef,
                          [f(*xs) for xs in zip(leaves, *others)])


def tree_zeros_like(tree: Pytree) -> Pytree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.sub, a, b)


def tree_mul(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.mul, a, b)


def tree_scale(s, tree: Pytree) -> Pytree:
    return tree_map(lambda x: s * x, tree)


def tree_axpy(a, x: Pytree, y: Pytree) -> Pytree:
    """a*x + y, elementwise over the tree (two rounded operations, as the
    un-jitted JAX expression)."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt.  PyTorch's CPU ``torch.sqrt`` is one
    bit off on some f32 inputs (``jnp.sqrt`` and CUDA's ``sqrtf`` are
    not); the double route rounds once."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def tree_sq_l2(tree: Pytree) -> torch.Tensor:
    return sum(torch.sum(torch.square(l.to(torch.float32)))
               for l in tree_leaves(tree))


def tree_l2(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(tree_sq_l2(tree))


def tree_size(tree: Pytree) -> int:
    return sum(l.numel() for l in tree_leaves(tree))


def tree_gap(master: Pytree, view: Pytree) -> torch.Tensor:
    """The paper's *gap*: RMSE between master params and the params the
    worker computed its gradient on.  G(Δ) = ||Δ||_2 / sqrt(k)."""
    delta = tree_sub(master, view)
    k = tree_size(master)
    return tree_l2(delta) / np.sqrt(np.float32(k))


def tree_index(tree: Pytree, i) -> Pytree:
    """tree[i] along the leading axis of every leaf.  The leaves are
    VIEWS: read what you need before ``tree_set_index`` writes row i."""
    return tree_map(lambda l: l[i], tree)


def tree_set_index(tree: Pytree, i, value: Pytree) -> Pytree:
    """tree[i] <- value along the leading axis, IN PLACE (a functional
    copy would move the whole (N, ...) stack for an O(P) message).
    Returns ``tree`` itself."""
    for l, v in zip(tree_leaves(tree),
                    flatten_up_to(tree_flatten(tree)[1], value)):
        l[i] = v
    return tree


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Shared hyper-parameters for the async algorithms (paper App. A.5)."""
    lr: float = 0.1
    momentum: float = 0.9          # gamma
    weight_decay: float = 0.0
    dc_lambda: float = 2.0         # DC-ASGD / DANA-DC lambda (Zheng et al.)
    # LWP needs an estimate of the lag tau; with N equal workers the
    # steady-state lag is N-1 (paper Sec. 3.1 uses "tau" directly).
    lwp_tau: float | None = None

