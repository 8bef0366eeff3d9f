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
