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

Ported (paper algorithm numbers in brackets):
  asgd          plain ASGD, no momentum                      [Alg. 1+2]
  sa-asgd       staleness-aware ASGD, lr / tau per message   [Zhang et al.]
  nag-asgd      single shared momentum at the master         [Alg. 8, fn. 1]
  multi-asgd    per-worker momentum at the master            [Alg. 9]
  dc-asgd       delay compensation (Zheng et al. 2017)       [Alg. 10]
  lwp           linear weight prediction (Kosson et al.)     [Alg. 3]
  dana-zero     per-worker momentum + global look-ahead      [Alg. 4]
  dana-slim     Bengio-style, zero master overhead           [Alg. 6]
  dana-dc       DANA-Zero + delay compensation               [Alg. 7]
  dana-hetero   rate-weighted look-ahead                     [Sec. 3]
  nadam-asgd    one shared Nadam (m, u) pair at the master   [Sec. 7]
  dana-nadam    per-worker first moments + Nadam look-ahead  [Sec. 7]
  ga-asgd       gap-aware penalty (Barkai et al. 2020)       [App. C]
  ssgd          synchronous baseline (engine-driven barrier) [App. C]
  yellowfin     simplified closed-loop autotuner             [baseline]
  easgd         elastic averaging, per-worker replicas       [Zhang et al.]
  dana-easgd    easgd against the predicted centre           [Sec. 7]

State layout: tensors for the parameter-shaped entries; the step ``t`` is
a Python int and ``lr_prev`` / ``vscale`` / ``tau`` are host
``np.float32`` scalars, computed in the same float32 operation order as
the JAX package, so the two packages' states agree bit for bit.  The
per-worker scalars (sa-asgd's ``sent_t``, dana-hetero's ``last_t`` and
``interval``) are host float32 numpy vectors, replaced on every update.
ga-asgd's ``avg_step`` and yellowfin's seven tuner scalars are 0-d
tensors on the state's device: they depend on norms of device tensors,
and keeping them there spares the loop a sync.
``theta0`` is replaced by a new tree on every receive (views handed out
earlier stay valid); per-worker stacks (``v``, ``m``, ``sent``) are
updated in place, one row per message (easgd's replicas ``x`` too; its
send hands out a copy of row i).

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
from .types import (HyperParams, Pytree, sqrt_rn, tree_add, tree_axpy,
                    tree_gap, tree_index, tree_l2, tree_leaves, tree_map,
                    tree_mul, tree_scale, tree_set_index, tree_size,
                    tree_sq_l2, tree_sub, tree_zeros_like)

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


def _stacked_broadcast(params: Pytree, n: int) -> Pytree:
    return tree_map(
        lambda l: l.unsqueeze(0).expand((n,) + tuple(l.shape)).clone(),
        params)


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
        """w_j = r_j / r_i from the per-worker interval EMA (host f32)."""
        rates = _F32(1.0) / np.maximum(state["interval"], _F32(1e-6))
        return rates / np.maximum(rates[i], _F32(1e-6))

    def send(self, state: dict, i) -> tuple[Pytree, dict]:
        if self.send_source is None:
            view = state["theta0"]
        else:
            src = state[self.send_source]
            if self.send_stacked:
                first = tree_leaves(src)[0]
                if self.send_weights == "rate":
                    w = torch.from_numpy(
                        self._send_rate_weights(state, i)).to(first.device)
                else:
                    w = torch.ones((first.shape[0],), dtype=torch.float32,
                                   device=first.device)
                src = tree_map(lambda s: torch.tensordot(w, s, dims=1),
                               src)
            c = self._send_scale(state)
            if self.send_adaptive:
                view = tree_map(
                    lambda t, s, u: t - (c * s) / (sqrt_rn(u) + self.EPS),
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


class SAASGD(ASGD):
    """Staleness-aware ASGD (Zhang et al.): lr / tau per message.

    The master stamps the step each worker's view was sent at
    (``sent_t``, one host f32 scalar per worker) and divides the learning
    rate for worker i's gradient by its staleness tau = t - sent_t[i]
    (floored at 1, so synchronous pushes run at full lr).  The flat path
    keeps ``sent_t`` in the SENT_STEP scalar lane and folds the division
    into its per-message rates.
    """

    name = "sa-asgd"

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["sent_t"] = np.zeros((num_workers,), _F32)
        return s

    def send(self, state, i):
        view, state = super().send(state, i)
        state = dict(state)
        sent_t = state["sent_t"].copy()
        sent_t[i] = _F32(state["t"])
        state["sent_t"] = sent_t
        return view, state

    def receive(self, state, i, grad, now=0.0):
        lr, _ = self._lr_and_correction(state)
        tau = np.maximum(_F32(state["t"]) - state["sent_t"][i], _F32(1.0))
        lr = lr / tau
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


class DCASGD(Algorithm):
    """Delay-compensated ASGD (Zheng et al. 2017), Algorithm 10.

    ghat = g + lambda * g (.) g (.) (theta0 - theta_sent_i)
    """

    name = "dc-asgd"
    snapshot_key = "sent"

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["v"] = _stacked_zeros(s["theta0"], num_workers)
        s["vscale"] = self._vscale_init()
        s["sent"] = _stacked_broadcast(s["theta0"], num_workers)
        return s

    def receive(self, state, i, grad, now=0.0):
        g = _F32(self.hp.momentum)
        lr, vscale = self._lr_and_vscale(state)
        state = dict(state)
        ghat = _delay_compensated(state, i, grad, _F32(self.hp.dc_lambda))
        vi = tree_axpy(g, tree_index(state["v"], i),
                       tree_scale(_F32(1.0) / vscale, ghat))
        state["theta0"] = tree_axpy(-lr * vscale, vi, state["theta0"])
        state["v"] = tree_set_index(state["v"], i, vi)
        state["vscale"] = vscale
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state


def _delay_compensated(state: dict, i, grad, lam):
    """grad + lam * ((grad * grad) * (theta0 - sent_i))."""
    delta = tree_sub(state["theta0"], tree_index(state["sent"], i))
    return tree_add(grad, tree_scale(lam, tree_mul(tree_mul(grad, grad),
                                                   delta)))


class LWP(Algorithm):
    """Linear Weight Prediction (Kosson et al. 2020), Algorithm 3.

    Master keeps a single momentum vector and sends the tau-step linear
    extrapolation theta0 - tau*eta*v.
    """

    name = "lwp"
    send_source = "v"
    send_tau = True
    send_vscale = True

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["v"] = tree_zeros_like(s["theta0"])
        s["vscale"] = self._vscale_init()
        tau = (self.hp.lwp_tau if self.hp.lwp_tau is not None
               else float(max(num_workers - 1, 1)))
        s["tau"] = _F32(tau)
        return s

    def receive(self, state, i, grad, now=0.0):
        g = _F32(self.hp.momentum)
        lr, vscale = self._lr_and_vscale(state)
        state = dict(state)
        v = tree_axpy(g, state["v"],                    # stored scale
                      tree_scale(_F32(1.0) / vscale, grad))
        state["theta0"] = tree_axpy(-lr * vscale, v, state["theta0"])
        state["v"] = v
        state["vscale"] = vscale
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state


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


class DanaDC(DanaZero):
    """DANA-DC (Algorithm 7): DANA-Zero + delay compensation."""

    name = "dana-dc"
    snapshot_key = "sent"
    snapshot_view = True      # the snapshot is the view the worker GOT

    def init(self, params, num_workers):
        s = super().init(params, num_workers)
        s["sent"] = _stacked_broadcast(s["theta0"], num_workers)
        return s

    def receive(self, state, i, grad, now=0.0):
        ghat = _delay_compensated(state, i, grad, _F32(self.hp.dc_lambda))
        return super().receive(state, i, ghat, now)


class DanaHetero(DanaZero):
    """Rate-weighted DANA look-ahead (the extension the paper suggests:
    "monitoring the rate of each worker's updates and weighting them
    accordingly").

    The master tracks an EMA of each worker's push interval.  Worker i's
    look-ahead weights each v^j by the expected number of worker-j
    updates during one of worker i's intervals, r_j / r_i:

        theta_hat_i = theta0 - eta*gamma * sum_j (r_j / r_i) v^j

    ``interval`` and ``last_t`` are host f32 vectors advanced from the
    message timestamps ``now``.
    """

    name = "dana-hetero"
    RATE_EMA = 0.8
    send_source = "v"
    send_stacked = True
    send_weights = "rate"
    send_gamma = True
    send_vscale = True

    def init(self, params, num_workers):
        s = super().init(params, num_workers)
        s["last_t"] = np.zeros((num_workers,), _F32)
        s["interval"] = np.ones((num_workers,), _F32)
        return s

    def receive(self, state, i, grad, now=0.0):
        state = dict(state)
        now = _F32(now)
        interval, last_t = state["interval"].copy(), state["last_t"].copy()
        dt = np.maximum(now - last_t[i], _F32(1e-6))
        interval[i] = (_F32(self.RATE_EMA) * interval[i]
                       + _F32(1 - self.RATE_EMA) * dt)
        last_t[i] = now
        state["interval"], state["last_t"] = interval, last_t
        return super().receive(state, i, grad, now)


class NadamASGD(Algorithm):
    """Naive async Nadam: ONE shared (m, u) moment pair at the master —
    the adaptive analogue of NAG-ASGD (the baseline of DANA-Nadam).

    Simplified Nadam (no bias correction):
        m <- b1*m + (1-b1)*g ;  u <- b2*u + (1-b2)*g^2
        theta <- theta - lr * (b1*m + (1-b1)*g) / (sqrt(u) + eps)
    """

    name = "nadam-asgd"
    B2 = 0.999
    EPS = 1e-8

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["m"] = tree_zeros_like(s["theta0"])
        s["u"] = tree_zeros_like(s["theta0"])
        return s

    def _moments(self):
        """b1, 1-b1, b2, 1-b2 as the JAX package's f32 operands (the
        differences are taken in double, then rounded)."""
        b1, b2 = self.hp.momentum, self.B2
        return _F32(b1), _F32(1 - b1), _F32(b2), _F32(1 - b2)

    def _apply(self, state, m_new, grad, u_new, lr):
        b1, c1, _, _ = self._moments()
        upd = tree_map(
            lambda m, g, u: (b1 * m + c1 * g) / (sqrt_rn(u) + self.EPS),
            m_new, grad, u_new)
        state["theta0"] = tree_axpy(-lr, upd, state["theta0"])
        return state

    def _second_moment(self, state, grad):
        _, _, b2, c2 = self._moments()
        return tree_map(lambda uu, g: b2 * uu + c2 * g * g, state["u"],
                        grad)

    def receive(self, state, i, grad, now=0.0):
        b1, c1, _, _ = self._moments()
        lr = self.schedule(state["t"])
        state = dict(state)
        m = tree_map(lambda mm, g: b1 * mm + c1 * g, state["m"], grad)
        u = self._second_moment(state, grad)
        state = self._apply(state, m, grad, u, lr)
        state.update(m=m, u=u, t=state["t"] + 1, lr_prev=lr)
        return state


class DanaNadam(NadamASGD):
    """DANA-Nadam: per-worker first moments m^i with the O(k) running sum
    m0 = sum_j m^j, the shared second moment u, and the DANA look-ahead
    in the adaptive geometry:

        send:  theta_hat = theta - lr * b1 * m0 / (sqrt(u) + eps)
    """

    name = "dana-nadam"
    send_source = "m0"
    send_gamma = True         # b1 IS hp.momentum
    send_adaptive = True      # / (sqrt(u) + EPS)

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["m"] = _stacked_zeros(s["theta0"], num_workers)
        s["m0"] = tree_zeros_like(s["theta0"])
        s["u"] = tree_zeros_like(s["theta0"])
        return s

    def receive(self, state, i, grad, now=0.0):
        b1, c1, _, _ = self._moments()
        lr = self.schedule(state["t"])
        state = dict(state)
        mi_old = tree_index(state["m"], i)                 # views of row i
        mi = tree_map(lambda mm, g: b1 * mm + c1 * g, mi_old, grad)
        # O(k) sum (App. A.2), BEFORE row i is overwritten
        m0 = tree_add(tree_sub(state["m0"], mi_old), mi)
        u = self._second_moment(state, grad)
        state = self._apply(state, mi, grad, u, lr)
        state.update(m=tree_set_index(state["m"], i, mi), m0=m0, u=u,
                     t=state["t"] + 1, lr_prev=lr)
        return state


class GapAware(Algorithm):
    """Gap-Aware staleness mitigation (Barkai, Hakimi & Schuster 2020,
    the paper's App. C "GA"), simplified: each incoming gradient is
    damped by worker i's gap relative to the running average step size,

        penalty_i = 1 + G(theta0 - theta_sent_i) / max(avg_step, eps)
        ghat      = g / penalty_i

    on top of per-worker momentum (like Multi-ASGD).  ``avg_step`` (an
    EMA of the RMS master step) is a 0-d tensor on the state's device.
    """

    name = "ga-asgd"
    EMA = 0.99
    snapshot_key = "sent"

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["v"] = _stacked_zeros(s["theta0"], num_workers)
        s["vscale"] = self._vscale_init()
        s["sent"] = _stacked_broadcast(s["theta0"], num_workers)
        s["avg_step"] = torch.tensor(
            1e-8, dtype=torch.float32,
            device=tree_leaves(s["theta0"])[0].device)
        return s

    def receive(self, state, i, grad, now=0.0):
        g = _F32(self.hp.momentum)
        lr, vscale = self._lr_and_vscale(state)
        state = dict(state)
        gap = tree_gap(state["theta0"], tree_index(state["sent"], i))
        penalty = 1.0 + gap / torch.clamp(state["avg_step"], min=1e-12)
        ghat = tree_scale(1.0 / penalty, grad)
        vi = tree_axpy(g, tree_index(state["v"], i),
                       tree_scale(_F32(1.0) / vscale, ghat))
        state["theta0"] = tree_axpy(-lr * vscale, vi, state["theta0"])
        # the RMS size of one master update (the gap's unit)
        step_rms = lr * vscale * tree_l2(vi) / np.sqrt(_F32(tree_size(vi)))
        state["avg_step"] = (self.EMA * state["avg_step"]
                             + (1 - self.EMA) * step_rms)
        state["v"] = tree_set_index(state["v"], i, vi)
        state["vscale"] = vscale
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state


class SSGD(Algorithm):
    """Synchronous baseline: the engine gathers one gradient per worker
    at a barrier and calls ``receive_all`` with their mean (Bengio-NAG
    update)."""

    name = "ssgd"

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["v"] = tree_zeros_like(s["theta0"])
        return s

    def receive_all(self, state, mean_grad):
        g = _F32(self.hp.momentum)
        lr, corr = self._lr_and_correction(state)
        state = dict(state)
        v = tree_axpy(g, tree_scale(corr, state["v"]), mean_grad)
        upd = tree_axpy(g, v, mean_grad) if self.nesterov else v
        state["theta0"] = tree_axpy(-lr, upd, state["theta0"])
        state["v"] = v
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state

    def receive(self, state, i, grad, now=0.0):  # the engine: receive_all
        return self.receive_all(state, grad)


class YellowFin(Algorithm):
    """Simplified closed-loop YellowFin (Zhang & Mitliagkas 2019).

    EMA estimates of the curvature range (h_min, h_max) from squared
    gradient norms, of the gradient norm and of the distance to the
    optimum set the momentum from the paper's robustness condition:
    sqrt(mu) >= max((sqrt(h_max/h_min)-1)/(sqrt(h_max/h_min)+1),
                    1 - sqrt(lr * ||g||^2 / D)).
    The seven tuner scalars are 0-d f32 tensors on the state's device;
    the debias term b^(t+1) is a host f32 scalar (``t`` is on the host).
    """

    name = "yellowfin"
    BETA = 0.999

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["v"] = tree_zeros_like(s["theta0"])
        dev = tree_leaves(s["theta0"])[0].device

        def scalar(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)
        s.update(h_min=scalar(1e12), h_max=scalar(1e-12),
                 g2_ema=scalar(0.0), g_norm_ema=scalar(0.0),
                 dist_ema=scalar(0.0), mu=scalar(0.0),
                 lr_yf=scalar(self.hp.lr))
        return s

    def receive(self, state, i, grad, now=0.0):
        state = dict(state)
        b, c = _F32(self.BETA), _F32(1 - self.BETA)
        g2 = tree_sq_l2(grad)
        debias = _F32(1.0) - b ** np.maximum(_F32(state["t"]) + _F32(1),
                                             _F32(1))
        g2_ema = b * state["g2_ema"] + c * g2
        gn_ema = b * state["g_norm_ema"] + c * sqrt_rn(g2)
        h_min = torch.minimum(b * state["h_min"] + c * g2, g2)
        h_max = torch.maximum(b * state["h_max"] + c * g2, g2)
        dist = b * state["dist_ema"] + c * (
            gn_ema / torch.clamp(g2_ema, min=1e-12))
        ratio = sqrt_rn(torch.clamp(h_max, min=1e-12)
                        / torch.clamp(h_min, min=1e-12))
        mu_curv = torch.square((ratio - 1.0) / (ratio + 1.0))
        lr = state["lr_yf"]
        mu_noise = torch.square(1.0 - sqrt_rn(torch.clamp(
            lr * g2 / torch.clamp(dist / debias, min=1e-12), 0.0, 1.0)))
        mu = torch.clamp(torch.maximum(mu_curv, mu_noise), 0.0, 0.99)
        v = tree_axpy(mu, state["v"], tree_scale(lr, grad))
        state["theta0"] = tree_sub(state["theta0"], v)
        state.update(v=v, g2_ema=g2_ema, g_norm_ema=gn_ema, h_min=h_min,
                     h_max=h_max, dist_ema=dist, mu=mu,
                     t=state["t"] + 1, lr_prev=_F32(self.hp.lr))
        return state


class EASGD(Algorithm):
    """Elastic Averaging SGD (Zhang et al. 2015): each worker trains its
    own replica with momentum SGD; centre and replica pull toward each
    other with elastic force alpha every update (the tau=1 "EAMSGD"
    variant).

    State: the centre theta0 (the deployable parameters), per-worker
    replicas x^i and momenta v^i as (N, ...) stacks.  ``send`` hands
    worker i a copy of its replica."""

    name = "easgd"

    def __init__(self, hp: HyperParams = HyperParams(),
                 schedule: Schedule | None = None, nesterov: bool = True,
                 alpha: float = 0.1):
        super().__init__(hp, schedule, nesterov)
        self.alpha = alpha

    def init(self, params, num_workers):
        s = self._base_state(params, num_workers)
        s["x"] = _stacked_broadcast(s["theta0"], num_workers)
        s["v"] = _stacked_zeros(s["theta0"], num_workers)
        return s

    def send(self, state, i):
        # a copy: row i of the stack is written in place by receive
        return tree_map(torch.clone, tree_index(state["x"], i)), state

    def _center_target(self, state, i):
        return state["theta0"]

    def receive(self, state, i, grad, now=0.0):
        g, a = _F32(self.hp.momentum), _F32(self.alpha)
        lr = self.schedule(state["t"])
        state = dict(state)
        xi = tree_index(state["x"], i)
        vi = tree_axpy(g, tree_index(state["v"], i), grad)
        upd = tree_axpy(g, vi, grad) if self.nesterov else vi
        xi = tree_axpy(-lr, upd, xi)
        # elastic exchange against the (possibly predicted) centre
        diff = tree_sub(xi, self._center_target(state, i))
        xi = tree_axpy(-a, diff, xi)
        state["theta0"] = tree_axpy(a, diff, state["theta0"])
        state["x"] = tree_set_index(state["x"], i, xi)
        state["v"] = tree_set_index(state["v"], i, vi)
        state["t"] = state["t"] + 1
        state["lr_prev"] = lr
        return state


class DanaEASGD(EASGD):
    """DANA + EASGD: the elastic force pulls toward the PREDICTED centre
    theta0 - alpha * lr * gamma * sum_j v^j, where the centre will be
    after the other replicas' momenta push it (paper Sec. 7)."""

    name = "dana-easgd"

    def _center_target(self, state, i):
        g = _F32(self.hp.momentum)
        lr = self.schedule(state["t"])
        vsum = tree_map(lambda v: torch.sum(v, dim=0), state["v"])
        return tree_axpy((_F32(-self.alpha) * lr) * g, vsum,
                         state["theta0"])


REGISTRY: dict[str, type[Algorithm]] = {
    cls.name: cls for cls in [
        ASGD, SAASGD, NagASGD, MultiASGD, DCASGD, LWP, DanaZero, DanaSlim,
        DanaDC, DanaHetero, SSGD, YellowFin, NadamASGD, DanaNadam, EASGD,
        DanaEASGD, GapAware]
}


def make_algorithm(name: str, hp: HyperParams = HyperParams(),
                   schedule: Schedule | None = None, **kw) -> Algorithm:
    if name not in REGISTRY:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"choose from {sorted(REGISTRY)}")
    return REGISTRY[name](hp, schedule, **kw)
