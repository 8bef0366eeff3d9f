"""The paper's asynchronous algorithms as update rules over trees.

Every algorithm is an (init, send, receive) triple:

  * ``init(params, num_workers)``       -> state
  * ``send(state, i)``                  -> (view, state)   # params worker i
                                                           # computes grads on
  * ``receive(state, i, grad, now)``    -> state           # master applies
                                                           # worker i's message
  * ``master_params(state)``            -> deployable params

The discrete-event engine (``core/engine.py``) decides *when* send and
receive happen.

Ported so far (paper algorithm numbers in brackets):
  asgd          plain ASGD, no momentum                      [Alg. 1+2]
  nag-asgd      single shared momentum at the master         [Alg. 8, fn. 1]
  multi-asgd    per-worker momentum at the master            [Alg. 9]
  dana-zero     per-worker momentum + global look-ahead      [Alg. 4]
  dana-slim     Bengio-style, zero master overhead           [Alg. 6]
The rest of the JAX registry is listed in ROADMAP.md.

State layout: tensors for the parameter-shaped entries; the step ``t`` is
a Python int and ``lr_prev`` / ``vscale`` are host ``np.float32``
scalars, computed in the same float32 operation order as the JAX
package, so the two packages' states agree bit for bit.  ``theta0`` is
replaced by a new tree on every receive (views handed out earlier stay
valid); per-worker stacks are updated in place, one row per message.

Note on NAG vs heavy-ball at the master: Appendix Algs. 8/9 print the
heavy-ball update ``theta <- theta - eta*v`` while footnote 1 and the text
prescribe Nesterov.  The text is followed (Bengio-NAG update
``theta <- theta - eta*(gamma*v_new + g)``) by default, with
``nesterov=False`` for the literal appendix variant.  DANA-Zero uses the
literal Alg. 4 master update (plain ``-eta*v``) because there the Nesterov
look-ahead lives in the *send* path.
"""
from __future__ import annotations

import numpy as np
import torch

from .schedules import Schedule, constant, momentum_correction
from .types import (HyperParams, Pytree, tree_add, tree_axpy, tree_index,
                    tree_leaves, tree_map, tree_scale, tree_set_index,
                    tree_sub, tree_zeros_like)

_F32 = np.float32


def compose_send_scale(c, *, gamma=None, tau=None, vscale=None):
    """The send scale c(t) = lr(t) [* gamma] [* tau] [* vscale].

    ONE definition of the factor order, shared by the tree send
    (``Algorithm._send_scale``), the flat send
    (``FlatAlgorithm._send_scale``) and the batched kernel's per-message
    hat coefficients (``FlatAlgorithm._msg_scalars``).  Factors are host
    float32 scalars or (k,) vectors; None skips a factor.
    """
    if gamma is not None:
        c = c * gamma
    if tau is not None:
        c = c * tau
    if vscale is not None:
        c = c * vscale
    return c


def _stacked_zeros(params: Pytree, n: int) -> Pytree:
    return tree_map(
        lambda l: torch.zeros((n,) + tuple(l.shape), dtype=l.dtype,
                              device=l.device), params)


class Algorithm:
    """Base class.  Subclasses override ``receive`` and *declare* their
    send: the class attributes describe the look-ahead view

        view_i = theta0 - c(t) * sum_j w_j(state, i) * source_j  [/ denom]

    with c(t) = lr(t) [* gamma] [* tau] [* vscale]; the base ``send``
    interprets the description on trees, and the flat substrate
    (``kernels/flat_update/ops.SendSpec``) interprets the SAME fields on
    (R, 128) rows through the send-view kernel.
    """

    name: str = "base"
    uses_momentum = True
    EPS = 1e-8

    # -- declarative send (view construction) ---------------------------
    send_source: str | None = None   # state key reduced into the view
    send_stacked: bool = False       # source is a per-worker (N, ...) stack
    send_weights: str = "ones"       # "ones" | "rate" (w_j = r_j / r_i)
    send_gamma: bool = False         # c *= hp.momentum
    send_tau: bool = False           # c *= state["tau"]  (LWP)
    send_vscale: bool = False        # c *= state["vscale"] (lazy Goyal)
    send_adaptive: bool = False      # view denom sqrt(u) + EPS (Nadam)
    snapshot_key: str | None = None  # per-worker sent slab refreshed on send
    snapshot_view: bool = False      # snapshot <- view (dana-dc) vs theta

    def __init__(self, hp: HyperParams = HyperParams(),
                 schedule: Schedule | None = None, nesterov: bool = True):
        self.hp = hp
        self.schedule = schedule if schedule is not None else constant(hp.lr)
        self.nesterov = nesterov

    # -- common state plumbing ------------------------------------------
    def _base_state(self, params: Pytree, num_workers: int) -> dict:
        return {
            "theta0": tree_map(lambda l: l.to(torch.float32).clone(),
                               params),
            "t": 0,
            "lr_prev": _F32(self.schedule(0)),
        }

    def init(self, params: Pytree, num_workers: int) -> dict:
        raise NotImplementedError

    # -- the generic declarative send -----------------------------------
    def _send_scale(self, state: dict):
        """c(t): the host scalar the reduced source is applied with."""
        return compose_send_scale(
            self.schedule(state["t"]),
            gamma=_F32(self.hp.momentum) if self.send_gamma else None,
            tau=state["tau"] if self.send_tau else None,
            vscale=state["vscale"] if self.send_vscale else None)

    def _send_rate_weights(self, state: dict, i):
        """w_j = r_j / r_i from the per-worker interval EMA."""
        rates = 1.0 / torch.clamp(state["interval"], min=1e-6)   # [N]
        return rates / torch.clamp(rates[i], min=1e-6)

    def send(self, state: dict, i) -> tuple[Pytree, dict]:
        if self.send_source is None:
            view = state["theta0"]
        else:
            src = state[self.send_source]
            if self.send_stacked:
                if self.send_weights == "rate":
                    w = self._send_rate_weights(state, i)
                else:
                    first = tree_leaves(src)[0]
                    w = torch.ones((first.shape[0],), dtype=torch.float32,
                                   device=first.device)
                src = tree_map(lambda s: torch.tensordot(w, s, dims=1),
                               src)
            c = self._send_scale(state)
            if self.send_adaptive:
                view = tree_map(
                    lambda t, s, u: t - (c * s) / (torch.sqrt(u) + self.EPS),
                    state["theta0"], src, state["u"])
            else:
                view = tree_axpy(-c, src, state["theta0"])
        if self.snapshot_key is None:
            return view, state
        state = dict(state)
        sval = view if self.snapshot_view else state["theta0"]
        state[self.snapshot_key] = tree_set_index(state[self.snapshot_key],
                                                  i, sval)
        return view, state

    def receive(self, state: dict, i, grad: Pytree, now=0.0) -> dict:
        raise NotImplementedError

    def receive_send(self, state: dict, i, grad: Pytree,
                     now=0.0) -> tuple[dict, Pytree]:
        """One master round: apply worker i's gradient, return its fresh
        view."""
        state = self.receive(state, i, grad, now)
        view, state = self.send(state, i)
        return state, view

    def master_params(self, state: dict) -> Pytree:
        return state["theta0"]

    # momentum correction (Goyal et al. 2017), host scalars
    def _lr_and_correction(self, state: dict):
        lr = self.schedule(state["t"])
        factor = momentum_correction(None, lr, state["lr_prev"])
        return lr, factor

    # Lazy momentum-correction scale for (N, ...)-stacked momentum: the
    # stack stores v_true / vscale and the scalar ``vscale`` absorbs the
    # running product of correction factors, so a receive touches only
    # row i (plus any running sum).  Under a constant schedule corr == 1
    # and vscale stays exactly 1.0.
    def _lr_and_vscale(self, state: dict):
        lr = self.schedule(state["t"])
        corr = momentum_correction(None, lr, state["lr_prev"])
        # floored so a schedule reaching lr == 0 cannot poison 1/vscale
        return lr, state["vscale"] * np.maximum(corr, _F32(1e-30))

    @staticmethod
    def _vscale_init():
        return _F32(1.0)


class ASGD(Algorithm):
    """Plain asynchronous SGD (Algorithms 1 + 2), no momentum."""

    name = "asgd"
    uses_momentum = False

    def init(self, params, num_workers):
        return self._base_state(params, num_workers)

    def receive(self, state, i, grad, now=0.0):
        lr, _ = self._lr_and_correction(state)
        state = dict(state)
        state["theta0"] = tree_axpy(-lr, grad, state["theta0"])
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state


class NagASGD(Algorithm):
    """Single shared momentum vector at the master (NAG-ASGD)."""

    name = "nag-asgd"

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["v"] = tree_zeros_like(s["theta0"])
        s["vscale"] = self._vscale_init()
        return s

    def receive(self, state, i, grad, now=0.0):
        g = _F32(self.hp.momentum)
        lr, vscale = self._lr_and_vscale(state)
        state = dict(state)
        v = tree_axpy(g, state["v"],                  # v <- gamma*v + g
                      tree_scale(_F32(1.0) / vscale, grad))  # (stored scale)
        if self.nesterov:
            upd = tree_axpy(g * vscale, v, grad)      # gamma*v_true + g
            state["theta0"] = tree_axpy(-lr, upd, state["theta0"])
        else:
            state["theta0"] = tree_axpy(-lr * vscale, v, state["theta0"])
        state["v"] = v
        state["vscale"] = vscale
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state


class MultiASGD(Algorithm):
    """Per-worker momentum vectors at the master (Algorithm 9), with the
    literal heavy-ball master update and no look-ahead (the paper's
    ablation; the Bengio-NAG variant is algebraically DANA-Slim)."""

    name = "multi-asgd"

    def __init__(self, hp: HyperParams = HyperParams(),
                 schedule: Schedule | None = None, nesterov: bool = False):
        super().__init__(hp, schedule, nesterov)

    def receive(self, state, i, grad, now=0.0):
        g = _F32(self.hp.momentum)
        lr, vscale = self._lr_and_vscale(state)
        state = dict(state)
        vi = tree_index(state["v"], i)              # stored scale
        vi = tree_axpy(g, vi, tree_scale(_F32(1.0) / vscale, grad))
        if self.nesterov:
            upd = tree_axpy(g * vscale, vi, grad)   # gamma*v_true + g
            state["theta0"] = tree_axpy(-lr, upd, state["theta0"])
        else:
            state["theta0"] = tree_axpy(-lr * vscale, vi, state["theta0"])
        state["v"] = tree_set_index(state["v"], i, vi)
        state["vscale"] = vscale
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["v"] = _stacked_zeros(s["theta0"], num_workers)
        s["vscale"] = self._vscale_init()
        return s


class DanaZero(Algorithm):
    """DANA-Zero (Algorithm 4) with the O(k) running-sum trick (App. A.2).

    Master keeps a momentum vector per worker plus v0 = sum_j v^j, updated
    incrementally: v0 <- v0 - v_i_old + v_i_new.  The send path returns the
    estimated future position  theta_hat = theta0 - eta*gamma*v0.
    """

    name = "dana-zero"
    send_source = "v0"
    send_gamma = True
    send_vscale = True

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["v"] = _stacked_zeros(s["theta0"], num_workers)
        s["v0"] = tree_zeros_like(s["theta0"])
        s["vscale"] = self._vscale_init()
        return s

    def receive(self, state, i, grad, now=0.0):
        g = _F32(self.hp.momentum)
        lr, vscale = self._lr_and_vscale(state)
        state = dict(state)
        vi_old = tree_index(state["v"], i)                # views of row i
        vi = tree_axpy(g, vi_old, tree_scale(_F32(1.0) / vscale, grad))
        # O(k) incremental sum maintenance (Appendix A.2), BEFORE row i
        # is overwritten: vi_old is a view
        v0 = tree_add(tree_sub(state["v0"], vi_old), vi)
        state["theta0"] = tree_axpy(-lr * vscale, vi, state["theta0"])
        state["v"] = tree_set_index(state["v"], i, vi)
        state["v0"] = v0
        state["vscale"] = vscale
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state


class DanaSlim(Algorithm):
    """DANA-Slim (Algorithm 6): the master is a plain ASGD master over Theta;
    each *worker* keeps its own momentum and sends u = gamma*v_new + g.

    In the single-process simulator the worker momentum lives in the same
    state dict (one stacked row per worker) but is only ever touched on
    the worker's own receive path.  ``master_params`` is Theta, the
    NAG-shifted iterate.
    """

    name = "dana-slim"

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["v"] = _stacked_zeros(s["theta0"], num_workers)   # worker-side
        s["vscale"] = self._vscale_init()
        return s

    def receive(self, state, i, grad, now=0.0):
        g = _F32(self.hp.momentum)
        lr, vscale = self._lr_and_vscale(state)
        state = dict(state)
        vi = tree_axpy(g, tree_index(state["v"], i),        # worker-side
                       tree_scale(_F32(1.0) / vscale, grad))
        u = tree_axpy(g * vscale, vi, grad)                 # gamma*v_true + g
        state["theta0"] = tree_axpy(-lr, u, state["theta0"])  # ASGD master
        state["v"] = tree_set_index(state["v"], i, vi)
        state["vscale"] = vscale
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state


REGISTRY: dict[str, type[Algorithm]] = {
    cls.name: cls for cls in [ASGD, NagASGD, MultiASGD, DanaZero, DanaSlim]
}


def make_algorithm(name: str, hp: HyperParams = HyperParams(),
                   schedule: Schedule | None = None, **kw) -> Algorithm:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ported: "
            f"{sorted(REGISTRY)}); ROADMAP.md lists the order of the rest")
    return REGISTRY[name](hp, schedule, **kw)
