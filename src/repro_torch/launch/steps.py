"""Step builders: the DANA pod-round train step, prefill, decode.

Multi-pod train step: pods are DANA's asynchronous workers.  One step is
one master ROUND: each pod contributes a gradient taken at the shared
look-ahead point theta_hat = theta - lr*gamma*v0, and the sequential
master updates of the round collapse algebraically to

    v_p'   = gamma * v_p + g_p          (per pod)
    S      = sum_p v_p'                 (the round's one reduction)
    theta' = theta - lr * S
    v0'    = S

which reproduces the paper's Algorithm 4 with the O(k) running sum of
its Appendix A.2 (v0 = sum_p v_p is an invariant of the state).  With
one pod the step is Nesterov (the paper's Algorithm 5).

The JAX package runs the pods under ``jax.vmap`` over a pod-sharded
batch axis of a device mesh; the port runs on one device (the mesh is
ROADMAP A8), so the pods are a loop over the leading pod split of the
batch, and each pod's gradient folds into its momentum before the next
pod's is taken (one pod's gradient is alive at a time).  The arithmetic
is the JAX step's: theta_hat is cast leaf by leaf to bfloat16, each
pod's loss and gradient are taken with respect to those bfloat16 leaves
(so each gradient is rounded to bfloat16 and then widened to float32, as
the JAX step's ``cast16`` -> ``value_and_grad`` -> ``astype(float32)``),
microbatches are summed in float32 and divided by their count, and the
state's buffers are updated in place (the JAX step donates its state).
The step counter ``t`` is a 0-d int32 tensor, as in the JAX state (so
checkpoints of either package load in the other); the learning rate is
read on the host from ``int(t)``.

The serve steps bind a model's prefill and decode to a shape's cache
geometry; the JAX package's also bind the mesh's logical-axis rules and,
on a TPU, switch its Pallas kernels on, where the port's wrappers pick
the kernel by device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import InputShape
from ..core.schedules import Schedule, constant
from ..core.types import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..models.api import Model, cache_spec_for

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    lr: float = 1e-3
    momentum: float = 0.9
    microbatches: int = 1           # gradient accumulation (paper Sec. 5.4)


def init_train_state(model: Model, gen, num_pods: int = 1, device="cuda"):
    """theta (float32 parameters drawn from ``gen``), one momentum per pod
    stacked on a leading axis, the running sum v0, the step t."""
    theta = model.init(gen, device=device, dtype=torch.float32)

    def stack(leaf):
        return torch.zeros((num_pods,) + tuple(leaf.shape),
                           dtype=torch.float32, device=leaf.device)
    return {
        "theta": theta,
        "v": tree_map(stack, theta),
        "v0": tree_map(torch.zeros_like, theta),
        "t": torch.zeros((), dtype=torch.int32, device=device),
    }


def _split_leaf(leaf, n: int):
    """(n, B/n, ...) when n divides the batch, else the leaf repeated n
    times (the JAX step's broadcast)."""
    if leaf.dim() >= 2 and leaf.shape[0] % n == 0:
        return leaf.reshape((n, leaf.shape[0] // n) + tuple(leaf.shape[1:]))
    return leaf[None].expand((n,) + tuple(leaf.shape))


def _split(batch: dict, n: int) -> list[dict]:
    """The batch cut into n parts along its batch axis, as the JAX step
    cuts it over pods and over microbatches: axis 0 of ``tokens``,
    ``embeds``, ``enc_embeds``, a packed batch's ``segments``,
    ``positions`` and ``loss_mask``, and every other leaf; axis 1 of
    M-RoPE's (3, B, S) ``positions``."""
    parts = {}
    for key, leaf in batch.items():
        if key == "positions" and leaf.dim() == 3:
            parts[key] = leaf.reshape(
                3, n, leaf.shape[1] // n, leaf.shape[2]).movedim(1, 0)
        else:
            parts[key] = _split_leaf(leaf, n)
    return [{key: part[i] for key, part in parts.items()} for i in range(n)]


def build_train_step(model: Model, settings: TrainSettings,
                     schedule: Schedule | None = None):
    """Returns ``step(state, batch) -> (state, metrics)``, one pod round.
    The pod count is the leading axis of ``state["v"]``; the batch (a
    dict: ``tokens``, and ``embeds``, ``positions``, ``enc_embeds`` or a
    packed batch's ``segments`` and ``loss_mask`` where the model takes
    them) splits over the pods along its batch axis (``_split``),
    and each pod's part over the microbatches.  The loss is ``lm_loss``:
    the cross entropy plus 0.01 times the MoE router loss.  ``state`` is
    updated in place and returned; metrics: ``loss`` (the pods' mean),
    ``lr`` and ``grad_norm`` (the L2 norm of every pod's gradient
    together, summed leaf by leaf over the pods as they go)."""
    sched = schedule if schedule is not None else constant(settings.lr)
    mb = settings.microbatches

    def value_and_grad(leaves16, treedef, batch):
        with torch.enable_grad():
            loss = model.loss(tree_unflatten(treedef, leaves16), batch)
            grads = torch.autograd.grad(loss, leaves16)
        return loss.detach(), grads

    def pod_grad(leaves16, treedef, batch):
        if mb <= 1:                 # bfloat16, widened leaf by leaf below
            return value_and_grad(leaves16, treedef, batch)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        g_sum = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
                 for l in leaves16]
        for bi in _split(batch, mb):
            loss, g = value_and_grad(leaves16, treedef, bi)
            loss_sum = loss_sum + loss
            for a, x in zip(g_sum, g):
                a.add_(x.float())
            del g
        return loss_sum / mb, [a / mb for a in g_sum]

    def step(state, batch):
        lr = _F32(sched(int(state["t"])))
        gamma = _F32(settings.momentum)
        lr_gamma = float(lr * gamma)
        theta, v0 = state["theta"], state["v0"]
        v = tree_leaves(state["v"])
        num_pods = v[0].shape[0]
        with torch.no_grad():
            hat16 = tree_map(
                lambda t, s: (t - lr_gamma * s).to(torch.bfloat16), theta, v0)
        leaves16, treedef = tree_flatten(hat16)
        for l in leaves16:
            l.requires_grad_(True)
        losses, sq = [], [0.0] * len(v)
        for p, part in enumerate(_split(batch, num_pods)):
            loss, g = pod_grad(leaves16, treedef, part)
            losses.append(loss)
            with torch.no_grad():
                for i, (vi, gi) in enumerate(zip(v, g)):
                    gi = gi.float()
                    sq[i] = sq[i] + torch.sum(torch.square(gi))
                    vi[p].mul_(float(gamma)).add_(gi)
            del g
        del hat16, leaves16
        with torch.no_grad():
            s = [torch.sum(vi, dim=0) for vi in v]
            for th, si in zip(tree_leaves(theta), s):
                th.sub_(float(lr) * si)
            state["v0"] = tree_unflatten(tree_flatten(v0)[1], s)
            state["t"] = state["t"] + 1
            metrics = {"loss": torch.mean(torch.stack(losses)),
                       "lr": lr, "grad_norm": torch.sqrt(sum(sq))}
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------
def build_prefill_step(model: Model, shape: InputShape):
    spec = cache_spec_for(model.cfg, shape)

    def step(params, batch):
        return model.prefill(params, batch, spec)

    return step


def build_decode_step(model: Model, shape: InputShape):
    spec = cache_spec_for(model.cfg, shape)

    def step(params, token, cache):
        return model.decode_step(params, token, cache, spec)

    return step
