"""The MLP classifier used by the simulator (the stand-in for the
paper's ResNets: the experiments study optimizer behaviour under
asynchrony, which is architecture-agnostic).

Parameters are a list of ``{"w", "b"}`` dicts of tensors with weights in
the JAX package's ``(d_in, d_out)`` layout, so the flat layout and every
parity test see the same tree.  Initial weights come from a numpy
generator; gradients come from ``torch.autograd`` (the matrix products
are plain ``torch.matmul``, as the JAX package leaves them to XLA).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import tree_flatten, tree_unflatten


def init_mlp(rng: np.random.Generator, dims, device="cuda"):
    """He-normal weights, zero biases: (d_in, d_out) f32 per layer."""
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = (rng.standard_normal((d_in, d_out), dtype=np.float32)
             * np.float32(np.sqrt(2.0 / d_in)))
        params.append({
            "w": torch.from_numpy(w).to(device),
            "b": torch.zeros((d_out,), dtype=torch.float32, device=device),
        })
    return params


def mlp_apply(params, x):
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i + 1 < len(params):
            h = torch.relu(h)
    return h


def softmax_xent(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None]))


def make_classifier_fns(dims, weight_decay: float = 0.0):
    """Returns (init, grad_fn, eval_fn_factory) for an MLP classifier.

    ``init(rng, device="cuda")`` draws from a numpy generator;
    ``grad_fn(params, (x, y))`` returns the gradient tree;
    ``make_eval((x, y))`` returns ``eval_fn(params) -> (loss, acc)``.
    """

    def init(rng: np.random.Generator, device="cuda"):
        return init_mlp(rng, dims, device)

    def loss_fn(params, batch):
        x, y = batch
        loss = softmax_xent(mlp_apply(params, x), y)
        if weight_decay:
            l2 = sum(torch.sum(torch.square(p["w"])) for p in params)
            loss = loss + 0.5 * weight_decay * l2
        return loss

    def grad_fn(params, batch):
        leaves, treedef = tree_flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        return tree_unflatten(treedef, list(grads))

    def make_eval(eval_batch):
        x, y = eval_batch

        @torch.no_grad()
        def eval_fn(params):
            logits = mlp_apply(params, x)
            loss = softmax_xent(logits, y)
            acc = torch.mean((torch.argmax(logits, -1) == y).float())
            return loss, acc
        return eval_fn

    return init, grad_fn, make_eval


class ClassifierGradFn:
    """The MLP classifier's gradient as a picklable object.

    It carries only ``(dims, weight_decay)`` and builds the gradient
    function lazily, matching the JAX package's ``ClassifierGradFn``
    (whose process backend pickles it into every worker; the port's
    process backend is not ported yet, ROADMAP.md).
    """

    def __init__(self, dims, weight_decay: float = 0.0):
        self.dims = tuple(int(d) for d in dims)
        self.weight_decay = float(weight_decay)
        self._grad = None

    def __getstate__(self):
        return {"dims": self.dims, "weight_decay": self.weight_decay}

    def __setstate__(self, state):
        self.dims = state["dims"]
        self.weight_decay = state["weight_decay"]
        self._grad = None

    def __call__(self, params, batch):
        if self._grad is None:
            self._grad = make_classifier_fns(self.dims,
                                             self.weight_decay)[1]
        return self._grad(params, batch)


def quadratic_fns(dim: int = 50, cond: float = 100.0, seed: int = 0,
                  h=None, device="cuda"):
    """A deterministic ill-conditioned quadratic 0.5 x^T H x: handy for
    exact convergence tests of the momentum algebra.  Returns
    ``(params0, loss, grad_fn)`` like the JAX package's.

    H has eigenvalues ``logspace(0, log10(cond), dim)`` in a random
    orthogonal basis drawn from numpy's ``seed``; the JAX package draws
    its basis from ``jax.random``, so to run the same function pass its
    matrix as ``h`` (a (dim, dim) array)."""
    if h is None:
        rng = np.random.default_rng(seed)
        evals = np.logspace(0, np.log10(cond), dim)
        q = np.linalg.qr(rng.standard_normal((dim, dim)))[0]
        h = (q * evals) @ q.T
    h = torch.from_numpy(np.array(h, np.float32)).to(device)
    dim = h.shape[0]

    def loss(params, batch=None):
        x = params["x"]
        return 0.5 * (x @ h @ x)

    def grad_fn(params, batch=None):
        x = params["x"].detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss({"x": x}), [x])
        return {"x": g}

    params0 = {"x": torch.ones((dim,), dtype=torch.float32, device=device)}
    return params0, loss, grad_fn
