"""Flat-state dispatch for the asynchronous algorithm family.

``FlatAlgorithm`` wraps a kernel-eligible ``Algorithm`` and executes its
receive->send hot path on flat (R, 128) buffers (``core/flat.py``): state
is packed ONCE at init, every coalesced batch runs as ONE batched update
(the CUDA kernels for CUDA tensors, the plain version for CPU tensors),
and trees only appear at the edges (incoming gradients, outgoing views).

Kernel-eligible algorithms (exact types; ``FLAT_ELIGIBLE``):

  asgd         no momentum: the family update with gamma = 0       [Alg. 1+2]
  sa-asgd      asgd with lr / tau per message (SENT_STEP lane)     [Zhang]
  dana-zero    per-worker momentum + v0 running sum + look-ahead   [Alg. 4]
  multi-asgd   per-worker momentum, heavy-ball (or Bengio) master  [Alg. 9]
  dana-slim    per-worker momentum, Bengio-NAG master              [Alg. 6]
  nag-asgd     shared momentum == the same kernel with N=1         [Alg. 8]
  lwp          shared momentum + tau-step look-ahead (hat "self")  [Alg. 3]
  dana-nadam   per-worker first moment + m0 sum + shared second
               moment, Nadam-preconditioned look-ahead             [Sec. 7]
  nadam-asgd   ONE shared (m, u) pair: the N=1 adaptive member     [Sec. 7]
  dc-asgd      + per-worker ``sent`` snapshot slab, delay
               compensation lam*g^2*(theta - sent_i)               [Alg. 10]
  dana-dc      DANA-Zero + delay compensation, snapshot = the
               look-ahead view the worker actually received        [Alg. 7]
  dana-hetero  rate-weighted look-ahead: the hat mixes ALL N
               momentum slabs with w_j = r_j / r_i (rate lane)     [Sec. 3]
  ga-asgd      + gap penalty 1 + G(theta - sent_i)/avg_step: the
               one non-elementwise member, run by the gap-aware
               kernel (``flat_update_batch_gap``)                  [App. C]

Sends are declarative: each ``Algorithm`` describes its view construction
(``send_source`` / ``send_weights`` / ... class fields) and ``SendSpec``
binds that description to the flat layout: the batched kernel builds
per-message look-ahead views from it (hat modes), and pull-path sends run
the send-view kernel (``send.py``).  The sent-snapshot members (dc-asgd,
dana-dc, ga-asgd) refresh worker i's ``sent`` row on every send and
every reply; sa-asgd and they stamp worker i's SENT_STEP lane slot.

Per-message scalars (lr(t+j), the momentum-correction product, the hat
coefficients, sa-asgd's staleness, dana-hetero's rate weights) are
computed on the host in float32, in the JAX package's operation order,
from host state: ``t`` / ``lr_prev`` / ``vscale`` / ``tau`` scalars and
the per-worker scalar LANES.  The JAX package keeps its lanes (``wscal``
with the SENT_STEP stamps, ``rate`` with dana-hetero's ``interval`` /
``last_t``) on the device; the port keeps the same (N, 128) f32 layout
in host numpy arrays (``core/flat.ScalarLane``), advanced in the JAX
order, so the loop never waits on the device for a per-message scalar.
``convert.flat_state_from_numpy`` and ``unpack_state`` translate between
the two forms.  ga-asgd's ``avg_step`` is the exception: it is a norm of
device state, so it stays a 0-d tensor on the device, updated in place.

The row-sharded master (``cluster/sharded.py``) runs the same executor
on row ranges: ``slice_flat`` / ``merge_flat`` cut and join states,
``view_rows`` sends over a row range (also the hot-row pull), and
ga-asgd, whose penalty needs a norm over every row, runs message by
message through ``gap_partial`` / ``apply_gap_message`` /
``finish_gap_message`` with the shards' partial sums exchanged between
them (plain torch ops, as the JAX package's are plain jnp).
``eligibility_matrix()`` is the documented contract, the JAX package's
dict for all 17 names.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.algorithms import (ASGD, DCASGD, LWP, SAASGD, DanaDC,
                                DanaHetero, DanaNadam, DanaSlim, DanaZero,
                                GapAware, MultiASGD, NadamASGD, NagASGD,
                                compose_send_scale)
from ...core.flat import (RATE_INTERVAL, RATE_LANE, RATE_LAST_T, SENT_LANE,
                          SENT_STEP, FlatSpec)
from ...core.schedules import momentum_correction
from ...core.types import sqrt_rn
from .kernel import flat_update_batch, flat_update_batch_gap
from .ref import flat_master_update_batch_ref
from .send import flat_send_view

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """Static shape of one family member's receive rule."""
    momentum_key: str | None     # per-worker momentum state key; None
    #                              (asgd) packs a zero N=1 slab, gamma=0
    sum_key: str | None          # running-sum key (v0/m0) or None
    u2_key: str | None           # second-moment key (adaptive) or None
    nesterov: bool               # master update uses gamma*v' + cg*g
    shared_momentum: bool        # momentum not stacked (nag-asgd): N=1 slab
    grad_coef: float = 1.0       # cg: 1, or (1 - beta1) for Nadam
    gamma: float | None = None   # momentum coefficient override (asgd: 0)
    b2: float = 0.999
    eps: float = 1e-8
    sent_key: str | None = None  # per-worker sent-snapshot slab, or None
    sent_view: bool = False      # snapshot <- view (dana-dc) vs theta
    dc_lambda: float | None = None   # delay-compensation coefficient
    gap_aware: bool = False      # GA penalty: global norm over delta
    gap_ema: float = 0.99        # avg_step EMA coefficient
    rate_weighted: bool = False  # dana-hetero: rate lane + weighted hats
    rate_ema: float = 0.8        # interval EMA coefficient
    uses_vscale: bool = True     # lazy Goyal rescale (False: Nadam pair)
    staleness_lr: bool = False   # sa-asgd: lr / tau per message (the
    #                              SENT_STEP lane only, no snapshot slab)

    @property
    def elementwise(self) -> bool:
        """True iff every term is per-row local, the property row
        sharding rests on (the weighted hat mixes slab rows within one
        row, so dana-hetero is)."""
        return not self.gap_aware

    @property
    def stateful_send(self) -> bool:
        """True iff a send WRITES master state (the sent-snapshot slab
        and/or the staleness lane stamp), so a pure view (a hot-row
        pull) is no valid send for it."""
        return self.sent_key is not None or self.staleness_lr


@dataclasses.dataclass(frozen=True)
class SendSpec:
    """Static shape of one family member's send (view construction),
    bound to the flat layout:

        view_i = theta - c * sum_j w_j * slab[j]   [/ (sqrt(u2)+eps)]

    ``source`` names the flat buffer reduced into the view ("v0" — the
    running sum; "v" — the momentum slab; None — the view IS theta);
    the c factors mirror ``Algorithm._send_scale`` in the same order."""
    source: str | None           # "v0" | "v" | None
    stacked: bool = False        # reduce over ALL N slab rows
    weights: str = "ones"        # "ones" | "rate" (w_j = r_j / r_i)
    gamma: bool = False          # c *= gamma
    tau: bool = False            # c *= tau (lwp)
    vscale: bool = False         # c *= vscale
    adaptive: bool = False       # / (sqrt(u2) + eps)

    @property
    def hat_mode(self) -> str:
        """How the batched kernel builds per-message reply views: a
        stacked source reduces over ALL N slab rows (weighted), an
        unstacked momentum source is the one shared row (self)."""
        if self.source is None:
            return "theta"
        if self.source == "v0":
            return "v0"
        return "weighted" if self.stacked else "self"


def family_spec_for(algo) -> FamilySpec | None:
    """FamilySpec for ``algo``, or None if it must take the tree path."""
    t = type(algo)
    if t is ASGD:
        return FamilySpec(None, None, None, nesterov=False,
                          shared_momentum=True, gamma=0.0)
    if t is SAASGD:
        return FamilySpec(None, None, None, nesterov=False,
                          shared_momentum=True, gamma=0.0,
                          staleness_lr=True)
    if t is DanaZero:
        return FamilySpec("v", "v0", None, nesterov=False,
                          shared_momentum=False)
    if t is DanaHetero:
        return FamilySpec("v", "v0", None, nesterov=False,
                          shared_momentum=False, rate_weighted=True,
                          rate_ema=algo.RATE_EMA)
    if t is MultiASGD:
        return FamilySpec("v", None, None, nesterov=algo.nesterov,
                          shared_momentum=False)
    if t is DanaSlim:
        return FamilySpec("v", None, None, nesterov=True,
                          shared_momentum=False)
    if t is NagASGD:
        return FamilySpec("v", None, None, nesterov=algo.nesterov,
                          shared_momentum=True)
    if t is LWP:
        return FamilySpec("v", None, None, nesterov=False,
                          shared_momentum=True)
    if t is DanaNadam:
        return FamilySpec("m", "m0", "u", nesterov=True,
                          shared_momentum=False,
                          grad_coef=1.0 - algo.hp.momentum,
                          b2=algo.B2, eps=algo.EPS, uses_vscale=False)
    if t is NadamASGD:
        return FamilySpec("m", None, "u", nesterov=True,
                          shared_momentum=True,
                          grad_coef=1.0 - algo.hp.momentum,
                          b2=algo.B2, eps=algo.EPS, uses_vscale=False)
    if t is DCASGD:
        return FamilySpec("v", None, None, nesterov=False,
                          shared_momentum=False, sent_key="sent",
                          dc_lambda=algo.hp.dc_lambda)
    if t is DanaDC:
        return FamilySpec("v", "v0", None, nesterov=False,
                          shared_momentum=False, sent_key="sent",
                          sent_view=True, dc_lambda=algo.hp.dc_lambda)
    if t is GapAware:
        return FamilySpec("v", None, None, nesterov=False,
                          shared_momentum=False, sent_key="sent",
                          gap_aware=True, gap_ema=algo.EMA)
    return None


def send_spec_for(algo, fam: FamilySpec | None = None) -> SendSpec | None:
    """The algorithm's declarative send fields bound to the flat layout
    (its ``send_source`` state key mapped to the flat buffer name)."""
    fam = fam if fam is not None else family_spec_for(algo)
    if fam is None:
        return None
    if algo.send_source is None:
        return SendSpec(None)
    source = "v0" if algo.send_source == fam.sum_key else "v"
    return SendSpec(source, stacked=algo.send_stacked,
                    weights=algo.send_weights, gamma=algo.send_gamma,
                    tau=algo.send_tau, vscale=algo.send_vscale,
                    adaptive=algo.send_adaptive)


def kernel_eligible(algo) -> bool:
    """True iff ``algo``'s hot path can run on the flat batched kernels."""
    return family_spec_for(algo) is not None


def shard_bitexact(algo) -> bool:
    """True iff the row-sharded master reproduces the single flat master
    bit for bit for ``algo`` (elementwise update rules only: the
    gap-aware penalty sums per-shard norm partials, which reorders the
    reduction)."""
    fam = family_spec_for(algo)
    return fam is not None and fam.elementwise


# the flat-eligible set (the JAX package's, all ported)
FLAT_ELIGIBLE = ("asgd", "dana-dc", "dana-hetero", "dana-nadam",
                 "dana-slim", "dana-zero", "dc-asgd", "ga-asgd", "lwp",
                 "multi-asgd", "nadam-asgd", "nag-asgd", "sa-asgd")
# the subset whose SEND builds a look-ahead view through the send-view
# kernel (everyone else sends a copy of theta)
SEND_KERNEL = ("dana-dc", "dana-hetero", "dana-nadam", "dana-zero",
               "lwp")


def eligibility_matrix() -> dict[str, dict[str, bool]]:
    """{algorithm name: {flat, send_kernel, schedule, shard,
    shard_bitexact}} for the whole registry, the JAX package's contract:

    * ``flat`` -- the hot path runs on the flat batched kernels;
    * ``send_kernel`` -- the send is a look-ahead built by ``send_view``
      (the others send theta itself);
    * ``schedule`` -- flat execution supports moving lr schedules;
    * ``shard`` -- the row-sharded master supports it;
    * ``shard_bitexact`` -- sharded == single master bit for bit.
    """
    from ...core.algorithms import REGISTRY, make_algorithm
    out = {}
    for name in sorted(REGISTRY):
        algo = make_algorithm(name)
        fam = family_spec_for(algo)
        send = send_spec_for(algo, fam)
        out[name] = {
            "flat": fam is not None,
            "send_kernel": send is not None and send.source is not None,
            "schedule": fam is not None,
            "shard": fam is not None,
            "shard_bitexact": fam is not None and fam.elementwise,
        }
    return out


# ---------------------------------------------------------------------------
# state <-> flat buffers
# ---------------------------------------------------------------------------
def pack_state(algo, state: dict, spec: FlatSpec | None = None):
    """Algorithm state dict -> flat dict {theta, v, [v0], [u2], [sent],
    [wscal], [rate], [tau], [avg_step], t, lr_prev, [vscale]}: tensors
    for the row buffers and avg_step, host scalars and host lanes for the
    rest."""
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
    if fam.u2_key is not None:
        flat["u2"] = spec.pack(state[fam.u2_key])
    if fam.sent_key is not None:
        flat["sent"] = spec.pack_stacked(state[fam.sent_key])
        # staleness lane: every snapshot is as old as the adoption point
        flat["wscal"] = SENT_LANE.init(flat["sent"].shape[0],
                                       **{SENT_STEP: flat["t"]})
    elif fam.staleness_lr:
        flat["wscal"] = SENT_LANE.init(len(state["sent_t"]),
                                       **{SENT_STEP: state["sent_t"]})
    if fam.rate_weighted:
        flat["rate"] = RATE_LANE.pack({RATE_INTERVAL: state["interval"],
                                       RATE_LAST_T: state["last_t"]})
    if algo.send_tau:
        flat["tau"] = _F32(state["tau"])
    if fam.gap_aware:
        flat["avg_step"] = state["avg_step"].clone()   # updated in place
    if "vscale" in state:
        flat["vscale"] = _F32(state["vscale"])
    return flat, spec


_ROW_KEYS = ("theta", "v", "v0", "u2", "sent")   # buffers laid out by row


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    return x                       # host scalars are immutable


def slice_flat(flat: dict, r0: int, r1: int) -> dict:
    """Rows [r0, r1) of a flat state, as a state of its own.

    The row buffers (``_ROW_KEYS``; the (N, R, 128) slabs keep their
    worker axis) become contiguous copies of their row range, so the
    batched kernel keeps contiguous inputs and shards never share a
    buffer; avg_step and the host lanes are copied, the host scalars
    shared (they are replaced, never written).  Every elementwise rule
    is per row, so ``apply_batch`` on the slice advances exactly its
    rows, bit for bit the full state's."""
    return {k: (v[..., r0:r1, :].clone(memory_format=torch.contiguous_format)
                if k in _ROW_KEYS else _copy(v))
            for k, v in flat.items()}


def merge_flat(pieces: list[dict]) -> dict:
    """Range-ordered shard states -> one full flat state: the row buffers
    concatenated along the row axis, everything else the first shard's
    (every shard applies every message with the same timestamps, so
    their scalars and lanes are the same)."""
    out = dict(pieces[0])
    for k in _ROW_KEYS:
        if k in out:
            out[k] = torch.cat([p[k] for p in pieces], dim=-2)
    return out


def unpack_state(algo, flat: dict, spec: FlatSpec) -> dict:
    """Flat dict -> the algorithm's tree state dict (views of the flat
    buffers; the lanes' columns as host vectors)."""
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
    if fam.u2_key is not None:
        state[fam.u2_key] = spec.unpack(flat["u2"])
    if fam.sent_key is not None:
        state[fam.sent_key] = spec.unpack_stacked(flat["sent"])
    if fam.staleness_lr:
        state["sent_t"] = SENT_LANE.get(flat["wscal"], SENT_STEP)
    if fam.rate_weighted:
        state["interval"] = RATE_LANE.get(flat["rate"], RATE_INTERVAL)
        state["last_t"] = RATE_LANE.get(flat["rate"], RATE_LAST_T)
    if "tau" in flat:
        state["tau"] = flat["tau"]
    if fam.gap_aware:
        state["avg_step"] = flat["avg_step"]
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
                             telemetry=False, avg_step=None,
                             gap_aware=False, gap_ema=0.99, n_elems=0):
    """The batched update on the state's device: a CUDA kernel for CUDA
    tensors (``flat_update_batch``, or ``flat_update_batch_gap`` for the
    gap-aware member; an error if they cannot run), the plain version
    for CPU tensors.  Updates the state (avg_step included) in place;
    returns (theta, v, v0, u2, sent, hats (k tensors, each its own
    buffer), pres or None)."""
    if gap_aware and (v0 is not None or u2 is not None or sent is None
                      or avg_step is None or nesterov
                      or dc_lambda is not None or sent_view
                      or hat_mode != "theta"):
        raise ValueError("the gap-aware update takes theta, v, sent and "
                         "avg_step with the heavy-ball rule and hat "
                         "'theta' (ga-asgd) only")
    if theta.device.type == "cuda":
        if gap_aware:
            theta, v, sent, _, hats, pres = flat_update_batch_gap(
                theta, v, sent, avg_step, g, ids, lrs, gammas, cgs,
                vscales, gap_ema=gap_ema, n_elems=n_elems,
                telemetry=telemetry)
            return theta, v, None, None, sent, hats, pres
        return flat_update_batch(
            theta, v, v0, u2, sent, g, ids, lrs, gammas, cgs, vscales, hcs,
            nesterov=nesterov, b2=b2, eps=eps, dc_lambda=dc_lambda,
            sent_view=sent_view, hat_mode=hat_mode, weights=weights,
            telemetry=telemetry)
    if theta.device.type != "cpu":
        raise ValueError(f"no flat update for device {theta.device}")
    out = flat_master_update_batch_ref(
        theta, v, v0, u2, sent, avg_step, g, ids, lrs, None, gammas, cgs,
        vscales, nesterov=nesterov, b2=b2, eps=eps, dc_lambda=dc_lambda,
        sent_view=sent_view, gap_aware=gap_aware, gap_ema=gap_ema,
        n_elems=n_elems, hat_mode=hat_mode, hcs=hcs, weights=weights,
        telemetry=telemetry)
    return out[:5] + out[6:]


# ---------------------------------------------------------------------------
# the flat executor
# ---------------------------------------------------------------------------
class FlatAlgorithm:
    """Flat-state executor with the Algorithm calling convention.

    ``init``/``send``/``receive_send``/``master_params`` mirror
    ``core.algorithms.Algorithm`` but the state is the flat dict, so the
    engine and the cluster master can swap it in without changing their
    loops.  ``tree_state`` gives the tree state back.

    The flat buffers are updated IN PLACE by ``apply_batch`` and, for
    the sent-snapshot members, by ``send_flat``: whatever must outlive
    the next batch is a copy (``master_params``, theta views of
    theta-senders); views built from ``hats`` or by the send kernel are
    fresh buffers.  The host scalars and lanes are replaced, never
    written, so callers keep the returned flat dict.
    """

    def __init__(self, algo):
        fam = family_spec_for(algo)
        if fam is None:
            raise ValueError(
                f"{algo.name!r} is not kernel-eligible; flat execution "
                f"covers exactly the asynchronous update family")
        self.algo = algo
        self.fam = fam
        self.send_spec = send_spec_for(algo, fam)
        self.name = algo.name
        self.hp = algo.hp
        self.schedule = algo.schedule
        self.lane = SENT_LANE if fam.stateful_send else None
        self.spec: FlatSpec | None = None
        # (N, device) -> the unit weights of the sends, made at the first
        # send (no allocation and fill at every send); the kernel only
        # reads them
        self._unit_weights: dict = {}

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

    def staleness(self, flat: dict):
        """Per-worker age (in master updates) of the last send, from the
        SENT_STEP lane (host f32), or None for stateless-send members."""
        if self.lane is None:
            return None
        return _F32(flat["t"]) - self.lane.get(flat["wscal"], SENT_STEP)

    def batch_staleness(self, flat: dict, wids, k: int):
        """Per-message staleness for a k-message batch, from the state
        BEFORE ``apply_batch``: message j applies at master step t + j
        against worker ``wids[j]``'s stamp, and a duplicate id chains
        through its own in-batch re-stamp (the stamps ``apply_batch``
        writes).  A (k,) host f32 vector, or None for stateless-send
        members."""
        if self.lane is None:
            return None
        sent = self.lane.get(flat["wscal"], SENT_STEP)
        t = _F32(flat["t"])
        out = np.empty((k,), _F32)
        for j in range(k):
            w = int(wids[j])
            out[j] = (t + _F32(j)) - sent[w]
            sent[w] = t + _F32(j + 1)
        return out

    # -- the flat send path ----------------------------------------------
    def _gamma(self) -> float:
        return (self.fam.gamma if self.fam.gamma is not None
                else self.hp.momentum)

    def _rate_weights(self, flat: dict, i):
        """w_j = r_j / r_i from the rate lane (host f32, mirroring
        ``Algorithm._send_rate_weights``)."""
        interval = RATE_LANE.get(flat["rate"], RATE_INTERVAL)
        rates = _F32(1.0) / np.maximum(interval, _F32(1e-6))
        return rates / np.maximum(rates[i], _F32(1e-6))

    def _send_scale(self, flat: dict):
        """c(t) through the SHARED ``compose_send_scale``."""
        sp = self.send_spec
        return compose_send_scale(
            self._sched(flat["t"]),
            gamma=_F32(self.hp.momentum) if sp.gamma else None,
            tau=flat["tau"] if sp.tau else None,
            vscale=flat.get("vscale", _F32(1.0)) if sp.vscale else None)

    def _view_flat(self, flat: dict, i=0, rows=None):
        """The view the family's send computes, on flat rows (on rows
        [r0, r1) only with ``rows``): the send view kernel for every
        look-ahead member, a copy of theta for the rest (the view
        escapes to a worker; theta is updated in place)."""
        sp = self.send_spec
        r0, r1 = (0, flat["theta"].shape[0]) if rows is None else rows
        theta = flat["theta"][r0:r1]
        if sp.source is None:
            return theta.clone()
        slab = flat["v0"][None] if sp.source == "v0" else flat["v"]
        if sp.weights == "rate":
            w = torch.from_numpy(self._rate_weights(flat, i)).to(
                slab.device)
        else:
            key = (slab.shape[0], slab.device)
            w = self._unit_weights.get(key)
            if w is None:
                w = self._unit_weights.setdefault(key, torch.ones(
                    (slab.shape[0],), dtype=torch.float32,
                    device=slab.device))
        return flat_send_view(theta, slab[:, r0:r1], w,
                              self._send_scale(flat),
                              u2=flat["u2"][r0:r1] if sp.adaptive else None,
                              eps=self.fam.eps)

    def view_rows(self, flat: dict, i, r0: int, r1: int):
        """Hot-row pull: the send view over ONLY rows [r0, r1), equal to
        ``_view_flat(flat, i)[r0:r1]`` bit for bit (every look-ahead
        reduction is per row).  The slab's row range is read in place
        (``send_view`` takes its pitch).  Pure (no state update), so it
        is a valid send only for the members whose send writes nothing
        (``not fam.stateful_send``).  An empty range gives a zero-row
        view and launches nothing."""
        if r1 <= r0:
            return flat["theta"].new_zeros((0, flat["theta"].shape[-1]))
        return self._view_flat(flat, i, rows=(r0, r1))

    def send_flat(self, flat: dict, i=0):
        """(view rows, flat): the wire-format send.  For the
        stateful-send members it writes worker i's ``sent`` row IN PLACE
        (the view for dana-dc, theta otherwise, as each algorithm's send
        does) and returns the state with worker i's SENT_STEP stamp set
        to t."""
        view = self._view_flat(flat, i)
        if self.lane is None:
            return view, flat
        if self.fam.sent_key is not None:
            flat["sent"][i].copy_(view if self.fam.sent_view
                                  else flat["theta"])
        new = dict(flat)
        new["wscal"] = self.lane.set_at(flat["wscal"], SENT_STEP, i,
                                        flat["t"])
        return view, new

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
        update rate lr(t+j), the look-ahead rate lr(t+j+1), the momentum
        coefficient, the gradient coefficient, the running
        momentum-correction product, and the hat coefficient (the send
        scale at the post-update step) — the exact sequence the tree
        path's k sequential receive->send rounds produce."""
        lrs = self._sched_vec(flat["t"], k, 0)
        lrs_next = self._sched_vec(flat["t"], k, 1)
        gammas = np.full((k,), self._gamma(), _F32)
        cgs = np.full((k,), self.fam.grad_coef, _F32)
        if self.fam.uses_vscale and "vscale" in flat:
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
            tau=flat["tau"] if sp.tau else None,
            vscale=vscales if sp.vscale else None)
        return lrs, lrs_next, gammas, cgs, vscales, hcs

    def _rate_trajectory(self, flat: dict, wids, nows, k: int):
        """Advance the rate lane through the k messages and collect the
        per-message weight rows w_jm = r_m / r_{i_j}, mirroring
        DanaHetero.receive's interval EMA and its send's weights message
        by message (duplicate ids chain through their own updates).
        Returns ((k, N) host f32 weights, the new lane)."""
        ema, one_m = _F32(self.fam.rate_ema), _F32(1 - self.fam.rate_ema)
        interval = RATE_LANE.get(flat["rate"], RATE_INTERVAL)
        last_t = RATE_LANE.get(flat["rate"], RATE_LAST_T)
        rows = []
        for j in range(k):
            i, now = int(wids[j]), _F32(nows[j])
            dt = np.maximum(now - last_t[i], _F32(1e-6))
            interval[i] = ema * interval[i] + one_m * dt
            last_t[i] = now
            rates = _F32(1.0) / np.maximum(interval, _F32(1e-6))
            rows.append(rates / np.maximum(rates[i], _F32(1e-6)))
        lane = RATE_LANE.pack({RATE_INTERVAL: interval,
                               RATE_LAST_T: last_t})
        return np.stack(rows), lane

    def apply_batch(self, flat: dict, ids, g_flat, nows=None, *,
                    telemetry: bool = False):
        """Apply k packed messages in one batched update.

        ids (k,) host ints; g_flat (k, R, 128) or k (R, 128) packed
        gradients on the state's device; ``nows`` (k,) message
        timestamps (host floats; only dana-hetero's rate lane reads
        them; zeros when absent).  Returns (flat', hats, thetas_pre
        (k,R,128) or None): hats are k (R,128) tensors that each own
        their storage (reply views outlive their batch); the row buffers
        of ``flat`` and avg_step are updated in place.
        """
        k = len(g_flat)
        wids = np.asarray(ids, np.int64).reshape(k)   # real ids (lanes)
        ids = np.zeros_like(wids) if self.fam.shared_momentum else wids
        nows = (np.zeros((k,), _F32) if nows is None
                else np.asarray(nows, _F32).reshape(k))
        lrs, _, gammas, cgs, vscales, hcs = self._msg_scalars(flat, k)
        if self.fam.staleness_lr:
            # Zhang et al.: lr_j / tau_j, tau floored at 1, folded into
            # the per-message rates as the tree path divides its lr
            lrs = lrs / np.maximum(self.batch_staleness(flat, wids, k),
                                   _F32(1.0))
        weights = rate_lane = None
        if self.fam.rate_weighted:
            weights, rate_lane = self._rate_trajectory(flat, wids, nows, k)
        elif self.send_spec.hat_mode == "weighted":
            # a stacked source with "ones" weights: a plain slab sum
            weights = np.ones((k, flat["v"].shape[0]), _F32)
        theta, v, v0, u2, sent, hats, pres = flat_master_update_batch(
            flat["theta"], flat["v"], flat.get("v0"), flat.get("u2"),
            flat.get("sent"), g_flat, ids, lrs, gammas, cgs, vscales, hcs,
            nesterov=self.fam.nesterov, b2=self.fam.b2, eps=self.fam.eps,
            dc_lambda=self.fam.dc_lambda, sent_view=self.fam.sent_view,
            hat_mode=self.send_spec.hat_mode, weights=weights,
            telemetry=telemetry, avg_step=flat.get("avg_step"),
            gap_aware=self.fam.gap_aware, gap_ema=self.fam.gap_ema,
            n_elems=self.spec.n_elems)
        new = dict(flat)
        new.update(theta=theta, v=v, t=flat["t"] + k, lr_prev=lrs[-1])
        if self.lane is not None:
            wscal = flat["wscal"]
            for j in range(k):
                wscal = self.lane.set_at(wscal, SENT_STEP, wids[j],
                                         flat["t"] + (j + 1))
            new["wscal"] = wscal
        if rate_lane is not None:
            new["rate"] = rate_lane
        if self.fam.uses_vscale and "vscale" in flat:
            new["vscale"] = vscales[-1]
        return new, hats, pres

    # -- the sharded gap-aware path (a norm exchanged across shards) ------
    # The gap penalty needs ||theta - sent_i|| over ALL rows; a row-range
    # shard holds some.  The sharded master runs ga-asgd one message at
    # a time: gap_partial (this shard's sum d^2) -> sum over shards ->
    # apply_gap_message with the total -> sum the ||v'||^2 partials ->
    # finish_gap_message (avg_step EMA).  The expressions are the plain
    # version's (``ref.py``) with its norms replaced by the exchanged
    # totals; sqrt(P) is the WHOLE model's (``self.spec``: the shards
    # share their owner's FlatAlgorithm).
    def _sqrt_p(self):
        return np.sqrt(_F32(self.spec.n_elems), dtype=_F32)

    def gap_partial(self, flat: dict, i):
        """This row range's sum of (theta - sent_i)^2, a 0-d tensor."""
        d = flat["theta"] - flat["sent"][i]
        return torch.sum(d * d)

    def apply_gap_message(self, flat: dict, i, g_row, gap2, view=None):
        """One gap-aware message on this shard's rows, with the shards'
        combined ``gap2`` (a host float).  Writes worker i's momentum and
        snapshot rows in place and replaces theta (the new theta is the
        reply view, a buffer of its own).  Returns (flat', hat,
        vn2 partial, lr, vs, d2, g2): flat' keeps the OLD avg_step
        (``finish_gap_message`` completes it); d2 / g2 are this shard's
        telemetry partials (None without ``view``)."""
        lrs, _, gammas, cgs, vscales, _ = self._msg_scalars(flat, 1)
        lr, gamma, cg, vs = lrs[0], gammas[0], cgs[0], vscales[0]
        pre = flat["theta"]
        gap = sqrt_rn(torch.full((), float(gap2), dtype=torch.float32,
                                 device=pre.device)) / self._sqrt_p()
        penalty = 1.0 + gap / torch.clamp(flat["avg_step"], min=1e-12)
        gj = (1.0 / penalty) * g_row
        v_new = gamma * flat["v"][i] + cg * ((_F32(1.0) / vs) * gj)
        theta = ((-lr) * vs) * v_new + pre
        flat["v"][i] = v_new
        flat["sent"][i] = theta
        new = dict(flat)
        new.update(theta=theta, t=flat["t"] + 1, lr_prev=lr, vscale=vs,
                   wscal=self.lane.set_at(flat["wscal"], SENT_STEP, i,
                                          flat["t"] + 1))
        vn2 = torch.sum(v_new * v_new)
        d2 = g2 = None
        if view is not None:
            dd = pre - view
            d2, g2 = torch.sum(dd * dd), torch.sum(g_row * g_row)
        return new, theta, vn2, lr, vs, d2, g2

    def finish_gap_message(self, flat: dict, vn2, lr, vs):
        """avg_step's EMA from the shards' combined ||v'||^2 (a host
        float)."""
        avg = flat["avg_step"]
        step_rms = lr * vs * sqrt_rn(torch.full(
            (), float(vn2), dtype=torch.float32, device=avg.device)) \
            / self._sqrt_p()
        new = dict(flat)
        new["avg_step"] = (self.fam.gap_ema * avg
                           + (1 - self.fam.gap_ema) * step_rms)
        return new

    def receive_send(self, flat: dict, i, grad, now=0.0):
        """One message through the batched path (k=1)."""
        g_flat = self.spec.pack(grad)[None]
        flat, hats, _ = self.apply_batch(flat, [i], g_flat, [now])
        return flat, self.spec.unpack(hats[0])

    def receive(self, flat: dict, i, grad, now=0.0):
        flat, _ = self.receive_send(flat, i, grad, now)
        return flat
