"""Flat-state dispatch for the asynchronous algorithm family.

``FlatAlgorithm`` wraps a kernel-eligible ``Algorithm`` and executes its
receive->send hot path on flat (R, 128) buffers (``core/flat.py``): state
is packed ONCE at init, every coalesced batch runs as ONE batched update
(the CUDA kernel for CUDA tensors, the plain version for CPU tensors),
and trees only appear at the edges (incoming gradients, outgoing views).

Kernel-eligible algorithms ported so far (exact types):

  asgd         no momentum: the family update with gamma = 0       [Alg. 1+2]
  dana-zero    per-worker momentum + v0 running sum + look-ahead   [Alg. 4]
  multi-asgd   per-worker momentum, heavy-ball (or Bengio) master  [Alg. 9]
  dana-slim    per-worker momentum, Bengio-NAG master              [Alg. 6]
  nag-asgd     shared momentum == the same kernel with N=1         [Alg. 8]

Sends are declarative: each ``Algorithm`` describes its view construction
and ``SendSpec`` binds that description to the flat layout: the batched
kernel builds per-message look-ahead views from it (hat modes theta and
v0), and pull-path sends run the send-view kernel (``send.py``).  Only
the fields on which the five members differ are carried; the rest of the
JAX package's FamilySpec/SendSpec (second moment, grad coefficient,
stacked or rate-weighted or tau-scaled sends) comes with the members
that need it.

Per-message scalars (lr(t+j), the momentum-correction product, the hat
coefficients) are computed on the host in float32, in the JAX package's
operation order, from the host scalars ``t`` / ``lr_prev`` / ``vscale``
the flat state keeps: the loop never waits on the device for them, and
moving schedules reproduce the tree path's receive->send bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.algorithms import (ASGD, DanaSlim, DanaZero, MultiASGD,
                                NagASGD, compose_send_scale)
from ...core.flat import FlatSpec
from ...core.schedules import momentum_correction
from .kernel import flat_update_batch
from .ref import flat_master_update_batch_ref
from .send import flat_send_view

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """Static shape of one family member's receive rule."""
    momentum_key: str | None     # per-worker momentum state key; None
    #                              (asgd) packs a zero N=1 slab, gamma=0
    sum_key: str | None          # running-sum key (v0) or None
    nesterov: bool               # master update uses gamma*v' + g
    shared_momentum: bool        # momentum not stacked (nag-asgd): N=1 slab
    gamma: float | None = None   # momentum coefficient override (asgd: 0)


@dataclasses.dataclass(frozen=True)
class SendSpec:
    """Static shape of one family member's send (view construction),
    bound to the flat layout:

        view_i = theta - c * v0

    ``source`` names the flat buffer in the view ("v0" — the running
    sum; None — the view IS theta); the c factors mirror
    ``Algorithm._send_scale`` in the same order."""
    source: str | None           # "v0" | None
    gamma: bool = False          # c *= gamma
    vscale: bool = False         # c *= vscale

    @property
    def hat_mode(self) -> str:
        """How the batched kernel builds per-message reply views."""
        return "theta" if self.source is None else "v0"


def family_spec_for(algo) -> FamilySpec | None:
    """FamilySpec for ``algo``, or None if it must take the tree path."""
    t = type(algo)
    if t is ASGD:
        return FamilySpec(None, None, nesterov=False,
                          shared_momentum=True, gamma=0.0)
    if t is DanaZero:
        return FamilySpec("v", "v0", nesterov=False,
                          shared_momentum=False)
    if t is MultiASGD:
        return FamilySpec("v", None, nesterov=algo.nesterov,
                          shared_momentum=False)
    if t is DanaSlim:
        return FamilySpec("v", None, nesterov=True,
                          shared_momentum=False)
    if t is NagASGD:
        return FamilySpec("v", None, nesterov=algo.nesterov,
                          shared_momentum=True)
    return None


def send_spec_for(algo, fam: FamilySpec | None = None) -> SendSpec | None:
    """The algorithm's declarative send fields bound to the flat layout."""
    fam = fam if fam is not None else family_spec_for(algo)
    if fam is None:
        return None
    if algo.send_source is None:
        return SendSpec(None)
    return SendSpec("v0", gamma=algo.send_gamma, vscale=algo.send_vscale)


# ---------------------------------------------------------------------------
# state <-> flat buffers
# ---------------------------------------------------------------------------
def pack_state(algo, state: dict, spec: FlatSpec | None = None):
    """Algorithm state dict -> flat dict {theta, v, [v0], t,
    lr_prev, [vscale]} (tensors for the row buffers, host scalars for
    the rest)."""
    fam = family_spec_for(algo)
    if spec is None:
        spec = FlatSpec.from_tree(state["theta0"])
    flat = {"theta": spec.pack(state["theta0"]),
            "t": int(state["t"]), "lr_prev": _F32(state["lr_prev"])}
    if fam.momentum_key is None:
        # momentum-free (asgd): a zero N=1 slab keeps the kernel shape;
        # gamma = 0 makes every row update ignore it bit-exactly
        flat["v"] = torch.zeros((1,) + tuple(flat["theta"].shape),
                                dtype=torch.float32,
                                device=flat["theta"].device)
    elif fam.shared_momentum:
        flat["v"] = spec.pack(state[fam.momentum_key])[None]
    else:
        flat["v"] = spec.pack_stacked(state[fam.momentum_key])
    if fam.sum_key is not None:
        flat["v0"] = spec.pack(state[fam.sum_key])
    if "vscale" in state:
        flat["vscale"] = _F32(state["vscale"])
    return flat, spec


def unpack_state(algo, flat: dict, spec: FlatSpec) -> dict:
    """Flat dict -> the algorithm's tree state dict (views of the flat
    buffers)."""
    fam = family_spec_for(algo)
    state = {"theta0": spec.unpack(flat["theta"]),
             "t": flat["t"], "lr_prev": flat["lr_prev"]}
    if fam.momentum_key is None:
        pass                                   # asgd: no momentum state
    elif fam.shared_momentum:
        state[fam.momentum_key] = spec.unpack(flat["v"][0])
    else:
        state[fam.momentum_key] = spec.unpack_stacked(flat["v"])
    if fam.sum_key is not None:
        state[fam.sum_key] = spec.unpack(flat["v0"])
    if "vscale" in flat:
        state["vscale"] = flat["vscale"]
    return state


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def flat_master_update_batch(theta, v, v0, u2, sent, g, ids, lrs, gammas,
                             cgs, vscales, hcs, *, nesterov, b2=0.999,
                             eps=1e-8, dc_lambda=None, sent_view=False,
                             hat_mode="theta", weights=None,
                             telemetry=False):
    """The batched update on the state's device: the CUDA kernel for
    CUDA tensors (or an error), the plain version for CPU tensors.
    Updates the state in place; returns (theta, v, v0, u2, sent, hats (k
    tensors, each its own buffer), pres or None)."""
    if theta.device.type == "cuda":
        return flat_update_batch(
            theta, v, v0, u2, sent, g, ids, lrs, gammas, cgs, vscales, hcs,
            nesterov=nesterov, b2=b2, eps=eps, dc_lambda=dc_lambda,
            sent_view=sent_view, hat_mode=hat_mode, weights=weights,
            telemetry=telemetry)
    if theta.device.type != "cpu":
        raise ValueError(f"no flat update for device {theta.device}")
    out = flat_master_update_batch_ref(
        theta, v, v0, u2, sent, None, g, ids, lrs, None, gammas, cgs,
        vscales, nesterov=nesterov, b2=b2, eps=eps, dc_lambda=dc_lambda,
        sent_view=sent_view, hat_mode=hat_mode, hcs=hcs, weights=weights,
        telemetry=telemetry)
    return out[:5] + out[6:]


# ---------------------------------------------------------------------------
# the flat executor
# ---------------------------------------------------------------------------
class FlatAlgorithm:
    """Flat-state executor with the Algorithm calling convention.

    ``init``/``send``/``receive_send``/``master_params`` mirror
    ``core.algorithms.Algorithm`` but the state is the flat dict, so the
    engine can swap it in without changing its loop.  ``tree_state``
    gives the tree state back.

    The flat buffers are updated IN PLACE by ``apply_batch``: whatever
    must outlive the next batch is a copy (``master_params``, theta
    views of theta-senders); views built from ``hats`` or by the send
    kernel are fresh buffers.
    """

    def __init__(self, algo):
        fam = family_spec_for(algo)
        if fam is None:
            raise NotImplementedError(
                f"{algo.name!r} has no flat path in the port yet "
                f"(ROADMAP.md)")
        self.algo = algo
        self.fam = fam
        self.send_spec = send_spec_for(algo, fam)
        self.name = algo.name
        self.hp = algo.hp
        self.schedule = algo.schedule
        self.spec: FlatSpec | None = None

    # -- Algorithm API ---------------------------------------------------
    def init(self, params, num_workers: int) -> dict:
        state = self.algo.init(params, num_workers)
        return self.adopt(state)

    def adopt(self, state: dict) -> dict:
        """Pack an ALREADY-initialized algorithm state into flat form."""
        flat, self.spec = pack_state(self.algo, state)
        return flat

    def master_params(self, flat: dict):
        """The master parameters as a tree (a copy: theta is updated in
        place by the next batch)."""
        return self.spec.unpack(flat["theta"].clone())

    def master_view(self, flat: dict):
        """The master parameters as views of flat theta (no copy): valid
        only until the next batch updates theta in place."""
        return self.spec.unpack(flat["theta"])

    def tree_state(self, flat: dict) -> dict:
        return unpack_state(self.algo, flat, self.spec)

    # -- the flat send path ----------------------------------------------
    def _gamma(self) -> float:
        return (self.fam.gamma if self.fam.gamma is not None
                else self.hp.momentum)

    def _send_scale(self, flat: dict):
        """c(t) through the SHARED ``compose_send_scale``."""
        sp = self.send_spec
        return compose_send_scale(
            self._sched(flat["t"]),
            gamma=_F32(self.hp.momentum) if sp.gamma else None,
            vscale=flat["vscale"] if sp.vscale else None)

    def _view_flat(self, flat: dict, i=0):
        """The view the family's send computes, on flat rows: the send
        view kernel over v0 for dana-zero, a copy of theta for the rest
        (the view escapes to a worker; theta is updated in place)."""
        if self.send_spec.source is None:
            return flat["theta"].clone()
        w = torch.ones((1,), dtype=torch.float32, device=flat["v0"].device)
        return flat_send_view(flat["theta"], flat["v0"][None], w,
                              self._send_scale(flat))

    def send_flat(self, flat: dict, i=0):
        """(view rows, flat): the wire-format send.  No ported member
        writes state on send."""
        return self._view_flat(flat, i), flat

    def send(self, flat: dict, i=0):
        view, flat = self.send_flat(flat, i)
        return self.spec.unpack(view), flat

    # -- per-message schedule scalars (host float32) ----------------------
    def _sched(self, t):
        return _F32(self.schedule(t))

    def _sched_vec(self, t0: int, k: int, off: int):
        """lr(t0 + off + j) for j in [0, k), as a (k,) f32 array."""
        return np.asarray([self._sched(t0 + off + j) for j in range(k)],
                          _F32)

    def _msg_scalars(self, flat: dict, k: int):
        """Per-message (lrs, lrs_next, gammas, cgs, vscales, hcs): the
        update rate lr(t+j), the look-ahead rate lr(t+j+1), the running
        momentum-correction product, and the hat coefficient (the send
        scale at the post-update step) — the exact sequence the tree
        path's k sequential receive->send rounds produce."""
        lrs = self._sched_vec(flat["t"], k, 0)
        lrs_next = self._sched_vec(flat["t"], k, 1)
        gammas = np.full((k,), self._gamma(), _F32)
        cgs = np.ones((k,), _F32)
        if "vscale" in flat:
            # mirror Algorithm._lr_and_vscale message by message
            vs, prev, seq = flat["vscale"], flat["lr_prev"], []
            for j in range(k):
                corr = momentum_correction(None, lrs[j], prev)
                vs = vs * np.maximum(corr, _F32(1e-30))
                seq.append(vs)
                prev = lrs[j]
            vscales = np.asarray(seq, _F32)
        else:
            vscales = np.ones((k,), _F32)
        sp = self.send_spec
        hcs = compose_send_scale(
            lrs_next,
            gamma=_F32(self.hp.momentum) if sp.gamma else None,
            vscale=vscales if sp.vscale else None)
        return lrs, lrs_next, gammas, cgs, vscales, hcs

    def apply_batch(self, flat: dict, ids, g_flat, nows=None, *,
                    telemetry: bool = False):
        """Apply k packed messages in one batched update.

        ids (k,) host ints; g_flat (k, R, 128) or k (R, 128) packed
        gradients on the state's device; ``nows`` (message timestamps)
        feeds only the rate-weighted member, which is not ported yet.
        Returns (flat', hats, thetas_pre (k,R,128) or None): hats are k
        (R,128) tensors that each own their storage (reply views outlive
        their batch); the row buffers of ``flat`` are updated in place.
        """
        k = len(g_flat)
        ids = np.asarray(ids, np.int64).reshape(k)
        if self.fam.shared_momentum:
            ids = np.zeros_like(ids)             # one shared slab row
        lrs, _, gammas, cgs, vscales, hcs = self._msg_scalars(flat, k)
        theta, v, _, _, _, hats, pres = flat_master_update_batch(
            flat["theta"], flat["v"], flat.get("v0"), None, None,
            g_flat, ids, lrs, gammas, cgs, vscales, hcs,
            nesterov=self.fam.nesterov, hat_mode=self.send_spec.hat_mode,
            telemetry=telemetry)
        new = dict(flat)
        new.update(theta=theta, v=v, t=flat["t"] + k, lr_prev=lrs[-1])
        if "vscale" in flat:
            new["vscale"] = vscales[-1]
        return new, hats, pres

    def receive_send(self, flat: dict, i, grad, now=0.0):
        """One message through the batched path (k=1)."""
        g_flat = self.spec.pack(grad)[None]
        flat, hats, _ = self.apply_batch(flat, [i], g_flat)
        return flat, self.spec.unpack(hats[0])

    def receive(self, flat: dict, i, grad, now=0.0):
        flat, _ = self.receive_send(flat, i, grad, now)
        return flat
