"""The parameter-server master: drains the mailbox, applies the algorithm.

The master is the paper's bottleneck above ~20 workers (App. C.1); the
attack here is **coalesced receive**: drain up to k queued messages and
apply them in ONE batched pass.  The pass preserves the engine's exact
semantics — for each message in order it runs ``receive(state, i, grad,
now)`` then ``send(state, i)`` (so every worker still gets the view it
would have gotten from per-message processing).

Three master paths, as in the JAX package:

* **flat** (the default whenever ``use_kernel``): every flat-eligible
  member runs on flat (R, 128) state packed ONCE at init, and all k
  drained messages go through ONE batched update: one launch of the
  CUDA kernel ``flat_update_batch``, or, for ga-asgd, the gap-aware
  kernel ``gap_update`` message by message (the plain version for CPU
  tensors).  The wire is flat too: workers receive
  (R, 128) views and push (R, 128) gradients (the runtime wraps their
  ``grad_fn`` with ``FlatSpec.unpack`` / ``FlatSpec.pack``), so the
  master thread never touches a tree on the hot path.  The kernel takes
  the k gradients as they arrived (no stacking copy) and writes each
  reply view into a buffer of its own, so a view kept by one worker pins
  only itself, never the rest of its batch.
* **legacy tree kernel** (explicit ``flat=False``, DANA-Zero only): the
  per-message ``dana_update`` round, one launch per leaf per message —
  kept only as the cross-check baseline for the batched path; it uses
  lr(t) for the look-ahead where the algorithm's send would use lr(t+1).
* **tree** (``use_kernel=False``): the algorithm's own receive->send on
  trees, message by message.

State that escapes: the flat state and the tree path's per-worker stacks
are updated in place, so reply views, the views a message carries for
telemetry and the parameters an eval reads are never views of them
(flat replies are fresh kernel outputs, ``master_params`` copies flat
theta; the tree path replaces ``theta0`` instead of writing it).

Telemetry is deferred: each batch's gaps and gradient norms stay on the
device and are spooled with their host metadata; the spool flushes to
``History`` (one ``.cpu()`` per spooled batch) at eval watermarks, at
its cap and at the end of the run, in the order the messages were
applied.  Gap and norm are the engine's own reductions (``tree_gap`` /
``tree_l2`` over the leaves), so the deterministic cluster's telemetry
equals the engine's bit for bit on both paths.  The sent-snapshot
members (dc-asgd, dana-dc, ga-asgd) also record each message's snapshot
staleness: on the flat path from the host SENT_STEP lane
(``FlatAlgorithm.batch_staleness``), on the tree path as the lag it
equals; the other members record NaN, as the engine does.

When the fused batch would cross an eval boundary, the serve loop
splits it there, so evals always observe the state at exactly a
multiple of ``eval_every`` applied messages.

Pulls (a rejoining worker's request without a gradient) get the send of
the worker's view; a pull that declares hot rows (``GradMsg.rows``) gets
the view over those rows only (``FlatAlgorithm.view_rows``: the
``send_view`` kernel reading that row range of the slab in place), on
flat masters whose send writes no state.  ``run_serve_loop`` is also
the row-sharded master's shard loop (``cluster/sharded.py``).

Workers and master share one CUDA device and one stream (PyTorch's
default): the device runs gradients and updates in the order the host
issued them, which the mailbox and the reply slots fix.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from ..core.algorithms import Algorithm, DanaZero
from ..core.metrics import History
from ..core.types import (tree_gap, tree_index, tree_l2, tree_leaves,
                          tree_scale, tree_set_index)
from ..kernels.dana_update import dana_master_update
from ..kernels.dana_update.kernel import LIB as DANA_LIB
from ..kernels.flat_update import (FlatAlgorithm, family_spec_for,
                                   kernel_eligible)
from ..kernels.flat_update._build import GAP_LIB
from ..kernels.flat_update._build import LIB as FLAT_LIB
from ..obs import trace
from .faults import FaultInjector
from .mailbox import GradMsg, Mailbox, Reply

_F32 = np.float32


def run_serve_loop(server):
    """The parameter-server drain loop.

    Per round: drain up to ``coalesce`` messages -> truncate gradient
    work to the remaining room (end-of-run overflow is rejected in
    ARRIVAL order) -> apply fault reordering to the accepted work ->
    chunk at the coalescing window and at eval watermarks -> reply to
    pulls -> reject overflow.  ``server`` provides mailbox/stop/total/
    applied/coalesce/injector/eval_boundary/slab_info plus
    ``_apply(chunk)`` and ``_pull_reply(msg)`` (which returns the number
    of view rows served, 0 when unknown); errors land on ``server.error``
    and raise the stop flag.  ``server.metrics`` (a
    ``serve_instruments`` bundle or None) gets the drained-batch-size
    histogram, pull/overflow counters and the slab-traffic counters
    (``slab_info = (n_slab_workers, rows_per_sender)`` on flat masters,
    None on the tree path); with tracing enabled the measured ``busy_s``
    interval doubles as the apply span.
    """
    msgs: list[GradMsg] = []
    try:
        while server.applied < server.total and not server.stop.is_set():
            msgs = server.mailbox.drain(server.coalesce, server.stop)
            if not msgs:
                continue
            work = [m for m in msgs if m.grad is not None]
            pulls = [m for m in msgs if m.grad is None]
            room = server.total - server.applied
            overflow, work = work[room:], work[:room]
            if server.injector is not None:
                work = server.injector.reorder(work)
            mx = server.metrics
            while work:
                # end-of-run truncation and pull filtering can leave any
                # k; chunks never cross an eval watermark
                k = min(len(work), server.coalesce)
                bnd = server.eval_boundary
                if bnd:
                    k = min(k, bnd - server.applied % bnd)
                chunk, work = work[:k], work[k:]
                server.coalesce_counts[k] = \
                    server.coalesce_counts.get(k, 0) + 1
                t_in = time.perf_counter()
                server._apply(chunk)
                dt = time.perf_counter() - t_in
                server.busy_s += dt
                if mx is not None:
                    mx.drain_k.observe(k)
                    info = server.slab_info
                    if info is not None:
                        # slab traffic: the kernel streams 2 slab rows
                        # (read + write) per UNIQUE sender; a full-slab
                        # pass would stream them for every worker
                        n_slab, rows2 = info
                        u = min(len({m.worker_id for m in chunk}), n_slab)
                        mx.slab_rows_streamed.add(u * rows2)
                        mx.slab_rows_total.add(n_slab * rows2)
                if trace.enabled:
                    trace.complete("apply", server.obs_cat, t_in, dt, k=k)
            if pulls and mx is not None:
                mx.pulls.add(len(pulls))
            for m in pulls:
                t_p = time.perf_counter() if trace.enabled else 0.0
                served_rows = server._pull_reply(m)
                if mx is not None and served_rows:
                    mx.pull_rows.add(served_rows)
                if trace.enabled:
                    trace.complete("pull", server.obs_cat, t_p,
                                   time.perf_counter() - t_p,
                                   worker=m.worker_id)
            if overflow and mx is not None:
                mx.overflow.add(len(overflow))
            for m in overflow:
                m.respond(None)
            msgs = []
    except BaseException as e:  # noqa: BLE001 - reported by run_cluster
        server.error = e
        server.stop.set()
    finally:
        # a mid-batch failure leaves drained messages unanswered;
        # release their workers instead of letting them hit rpc_timeout
        for m in msgs:
            if not m._event.is_set():
                m.respond(None)


class Master:
    def __init__(self, algo: Algorithm, state: dict, *,
                 mailbox: Mailbox, history: History, stop: threading.Event,
                 total_grads: int, coalesce: int = 1,
                 use_kernel: bool = False, flat: bool | None = None,
                 record_telemetry: bool = True,
                 eval_fn: Callable | None = None, eval_every: int = 100,
                 injector: FaultInjector | None = None,
                 time_fn: Callable[[GradMsg], float] | None = None,
                 pipeline_depth: int = 0):
        self.algo = algo
        self._tree_state: dict | None = state
        self._flat_algo: FlatAlgorithm | None = None
        self._flat_state: dict | None = None
        self.device = tree_leaves(state["theta0"])[0].device
        if use_kernel:
            if flat is None:
                flat = True
            if flat:
                if not kernel_eligible(algo):
                    raise ValueError(f"use_kernel=True but {algo.name!r} "
                                     f"has no flat path in the port")
                self._flat_algo = FlatAlgorithm(algo)
                self._flat_state = self._flat_algo.adopt(state)
                self._tree_state = None
            elif type(algo) is not DanaZero:
                raise ValueError(
                    f"the legacy (flat=False) kernel path implements "
                    f"exactly DANA-Zero, got {algo.name!r}")
        self.state_is_flat = self._flat_algo is not None
        self.legacy_kernel = bool(use_kernel) and not self.state_is_flat
        self.mailbox = mailbox
        self.history = history
        self.stop = stop
        self.total = total_grads
        self.coalesce = max(1, coalesce)
        self.record_telemetry = record_telemetry
        self.eval_every = max(1, eval_every)
        self.injector = injector
        self.error: BaseException | None = None
        self.applied = 0                   # gradient messages applied
        self._step = 0                     # master update counter
        self._eval_fn = eval_fn
        # chunks never straddle a multiple of this applied count (0 =
        # unconstrained): evals observe exact watermark states
        self.eval_boundary = self.eval_every if eval_fn is not None else 0
        # time source for History rows (virtual in deterministic/paced
        # modes, wall-clock seconds in free mode)
        self._time_fn = time_fn or (lambda m: m.t_send)
        self.coalesce_counts: dict[int, int] = {}   # drained-k histogram
        # observability: trace span category + serve-side instrument
        # bundle (attached by run_cluster when a registry is passed)
        self.obs_cat = "master"
        self.metrics = None
        # sent-snapshot members (dc-asgd, dana-dc, ga-asgd) refresh a
        # worker's snapshot on every send and reply, so a message's
        # snapshot staleness is its lag; the others record NaN (as the
        # engine does)
        fam = family_spec_for(algo)
        self._sent_family = fam is not None and fam.sent_key is not None
        # a send that writes state (a snapshot or the staleness stamp)
        # cannot be answered by a pure hot-row view
        self._stateful_send = fam is not None and fam.stateful_send
        self._view_rows_fns: dict = {}    # (r0, r1) -> hot-row view
        # worker pull-ahead depth (staleness accounting only; the
        # workers do the pipelining, see _flush_telemetry)
        self._pipeline_depth = max(0, int(pipeline_depth))
        # deferred telemetry: per-batch device tensors + host metadata,
        # flushed to History at eval watermarks / cap / end of run
        self._tele_spool: list = []
        self._tele_cap = 64
        # slab traffic model for the serve-loop counters
        self.slab_info = None
        if self.state_is_flat:
            v = self._flat_state["v"]
            self.slab_info = (int(v.shape[0]), 2 * int(v.shape[-2]))
        # steady-state marker: wall time when 20% of the grads have been
        # applied (ramp-up excluded from steady throughput)
        self._steady_mark = max(1, total_grads // 5)
        self.steady_t: float | None = None
        # master-thread occupancy applying gradients (drain waits
        # excluded): applied/busy_s is the master's live service rate
        self.busy_s = 0.0

    # -- worker-visible state -------------------------------------------
    @property
    def step(self) -> int:
        return self._step

    @property
    def state(self) -> dict:
        """The algorithm's tree state (views of the flat buffers in flat
        mode)."""
        if self.state_is_flat:
            return self._flat_algo.tree_state(self._flat_state)
        return self._tree_state

    def master_params(self):
        """The master parameters; a copy in flat mode (the flat state is
        updated in place), ``theta0`` itself on the tree paths (replaced,
        never written, by the next receive)."""
        if self.state_is_flat:
            return self._flat_algo.master_params(self._flat_state)
        return self.algo.master_params(self._tree_state)

    def initial_view(self, i: int):
        """Initial parameter pull for worker i (call in order 0..n-1 from
        ONE thread before workers start — mirrors the engine's warm-up)."""
        if self.state_is_flat:
            view, self._flat_state = self._flat_algo.send_flat(
                self._flat_state, i)
        else:
            view, self._tree_state = self.algo.send(self._tree_state, i)
        return view, self._step

    def warm(self, hot_ranges: tuple = ()):
        """Load every kernel library this master launches, before the
        workers start: the first use then builds and binds on this
        thread, not inside the serve loop.  ``hot_ranges`` (the distinct
        declared ``hot_rows``) get their row-view closures made here too
        (flat masters whose send writes no state).  Reads and writes no
        state and launches nothing."""
        if self.state_is_flat and not self._stateful_send:
            for r0, r1 in hot_ranges:
                self._view_rows_fn(int(r0), int(r1))
        if self.device.type != "cuda":
            return
        if self.state_is_flat:
            FLAT_LIB.load()
            if self._flat_algo.fam.gap_aware:
                GAP_LIB.load()
        elif self.legacy_kernel:
            DANA_LIB.load()

    # -- coalesced receive -------------------------------------------------
    def _one_legacy(self, state: dict, i: int, grad):
        """One legacy dana_update round: true-scale values in, stored
        scale (v_true / vscale) out."""
        algo = self.algo
        lr, vscale = algo._lr_and_vscale(state)
        vi_old = tree_index(state["v"], i)
        theta, vi, v0n, theta_hat = dana_master_update(
            state["theta0"], tree_scale(vscale, vi_old),
            tree_scale(vscale, state["v0"]), grad, lr, algo.hp.momentum)
        inv = _F32(1.0) / vscale
        state = dict(state)
        state.update(theta0=theta,
                     v=tree_set_index(state["v"], i, tree_scale(inv, vi)),
                     v0=tree_scale(inv, v0n), vscale=vscale,
                     t=state["t"] + 1, lr_prev=lr)
        return state, theta_hat

    def _apply_tree(self, work: list[GradMsg], telemetry: bool):
        """Message by message on trees; the staleness column is the lag
        (``_flush_telemetry``), so it returns None for it."""
        views, gaps, gnorms = [], [], []
        state = self._tree_state
        for m in work:
            if telemetry:
                gaps.append(tree_gap(self.algo.master_params(state),
                                     m.view))
                gnorms.append(tree_l2(m.grad))
            if self.legacy_kernel:
                state, view = self._one_legacy(state, m.worker_id, m.grad)
            else:
                state, view = self.algo.receive_send(state, m.worker_id,
                                                     m.grad, m.t_send)
            views.append(view)
        self._tree_state = state
        return views, gaps, gnorms, None

    def _apply_flat(self, work: list[GradMsg], telemetry: bool):
        fa = self._flat_algo
        ids = [m.worker_id for m in work]
        # per-message snapshot staleness from the host lane, read BEFORE
        # apply_batch restamps it (None unless a sent-snapshot member)
        stals = (fa.batch_staleness(self._flat_state, ids, len(work))
                 if telemetry and self._sent_family else None)
        self._flat_state, hats, pres = fa.apply_batch(
            self._flat_state, ids, [m.grad for m in work],
            [m.t_send for m in work], telemetry=telemetry)
        gaps, gnorms = [], []
        if telemetry:
            # the engine's reductions over the leaves (views of the flat
            # rows, padding excluded): bit-equal to its telemetry
            spec = fa.spec
            for j, m in enumerate(work):
                gaps.append(tree_gap(spec.unpack(pres[j]),
                                     spec.unpack(m.view)))
                gnorms.append(tree_l2(spec.unpack(m.grad)))
        return hats, gaps, gnorms, stals

    def _apply(self, work: list[GradMsg]):
        k = len(work)
        telemetry = self.record_telemetry
        t0 = self._step
        if self.state_is_flat:
            views, gaps, gnorms, stals = self._apply_flat(work, telemetry)
        else:
            views, gaps, gnorms, stals = self._apply_tree(work, telemetry)
        self._step = t0 + k
        if telemetry:
            # sync-free serve loop: gaps/gnorms stay on the device and
            # the per-message metadata is spooled; the flush replays
            # record() calls in the same order
            metas = [(self._time_fn(m), m.worker_id, m.view_step)
                     for m in work]
            self._tele_spool.append((t0, metas, gaps, gnorms, stals))
        evals = []
        for j, m in enumerate(work):
            self.applied += 1
            if self.applied == self._steady_mark:
                self.steady_t = time.perf_counter()
            m.respond(Reply(view=views[j], step=t0 + j + 1))
            if (self.applied % self.eval_every == 0
                    or self.applied == self.total):
                evals.append((self._time_fn(m), t0 + j + 1))
        if telemetry and (evals or len(self._tele_spool)
                          >= self._tele_cap):
            self._flush_telemetry()
        # eval uses the post-batch state; with coalescing k=1 (always true
        # in deterministic mode) this is exactly the engine's eval point.
        for t_ev, step_ev in evals:
            self._eval(t_ev, step_ev)

    def _flush_telemetry(self):
        """Drain the deferred telemetry spool into ``History`` — the only
        point where the master thread waits on the device for telemetry
        (one ``.cpu()`` per spooled batch)."""
        spool, self._tele_spool = self._tele_spool, []
        for t0, metas, gaps, gnorms, stals in spool:
            gaps = torch.stack(gaps).cpu().numpy()
            gnorms = torch.stack(gnorms).cpu().numpy()
            for j, (t_m, wid, vstep) in enumerate(metas):
                lag = t0 + j - vstep
                if not self._sent_family:
                    stal = float("nan")
                elif stals is None or self._pipeline_depth:
                    # the tree path; or pull-ahead, where the gradient was
                    # computed on an OLDER reply than the one that last
                    # restamped the lane, so the lane undercounts by the
                    # depth and the lag is the snapshot's true age
                    stal = float(lag)
                else:
                    stal = float(stals[j])
                self.history.record(
                    time=t_m, step=t0 + j + 1, worker=wid, lag=lag,
                    gap=float(gaps[j]), grad_norm=float(gnorms[j]),
                    staleness=stal)

    def _eval(self, t, step):
        if self._eval_fn is None:
            return
        out = self._eval_fn(self.master_params())
        loss, metric = (out if isinstance(out, tuple)
                        else (out, float("nan")))
        # record_eval's float() is the eval's .cpu() sync
        self.history.record_eval(time=t, step=step, loss=loss, metric=metric)

    def _view_rows_fn(self, r0: int, r1: int):
        """The hot-row view over rows [r0, r1), one closure a range,
        made by ``warm`` for every declared range."""
        fn = self._view_rows_fns.get((r0, r1))
        if fn is None:
            fa = self._flat_algo
            fn = self._view_rows_fns.setdefault(
                (r0, r1), lambda flat, i, a=r0, b=r1:
                fa.view_rows(flat, i, a, b))
        return fn

    def _pull_reply(self, m: GradMsg) -> int:
        if (self.state_is_flat and m.rows is not None
                and not self._stateful_send):
            # hot-row pull: the view over the declared rows only (row
            # local, bit-equal to the full view's rows).  Members whose
            # send writes state take the full send below (Reply.rows
            # stays None and the worker replaces its whole view).
            r0, r1 = int(m.rows[0]), int(m.rows[1])
            view = self._view_rows_fn(r0, r1)(self._flat_state,
                                              m.worker_id)
            m.respond(Reply(view=view, step=self._step, rows=(r0, r1)))
            return r1 - r0
        view, step = self.initial_view(m.worker_id)
        m.respond(Reply(view=view, step=step))
        return int(view.shape[-2]) if self.state_is_flat else 0

    # -- main loop -------------------------------------------------------
    def serve(self):
        try:
            run_serve_loop(self)
        finally:
            try:
                if self.record_telemetry:
                    self._flush_telemetry()
            except BaseException as e:  # noqa: BLE001 - surfaced below
                if self.error is None:
                    self.error = e
            finally:
                self.stop.set()     # run over (or failed): cluster done

    def reject_pending(self):
        """Post-shutdown: unblock any worker still waiting on a reply."""
        for m in self.mailbox.drain_nowait():
            m.respond(None)
