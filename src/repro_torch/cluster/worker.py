"""Worker thread: pull view -> compute gradient -> push -> repeat.

Pacing is pluggable:

* ``deterministic`` — the worker acquires its turn from the virtual clock
  (engine event order), so the whole cluster serializes into exactly the
  discrete-event schedule.
* ``paced``  — the worker sleeps a gamma-model execution time (scaled by
  ``time_scale``) before each push: wall-clock simulation fidelity.
* ``free``   — no pacing; the worker pushes as fast as it can compute
  (throughput mode — this is what fills the master's mailbox and makes
  coalesced receive pay off).

The push is a fused push-pull RPC: the reply carries the post-update view
(the engine's receive->send semantics), so a worker never computes two
gradients on the same view.

``pipeline_depth`` (live modes) turns the RPC into a pull-ahead
pipeline: the worker keeps up to ``depth`` pushes in flight and computes
its next gradient against the newest reply it HAS — the RPC round trip
overlaps with gradient compute instead of being dead time, at the cost
of exactly ``depth`` extra designed staleness.  ``depth=0`` is the fully
synchronous push-pull.  Each ``GradMsg`` is its own reply slot (see
``mailbox``), so pull-ahead needs no protocol change — the worker just
defers ``wait_reply``.

The worker is oblivious to the master's layout: view and gradient are
whatever its ``grad_fn`` consumes/produces — a tree (tree master), a
flat (R, 128) buffer (flat master), or a range-ordered tuple of row
slices (sharded master, where ``mailbox`` is the ``FanoutMailbox`` and
one push fans out to every shard).

Hot-row pulls: a worker with ``hot_rows`` asks, when it pulls without a
gradient (a rejoin), for just those flat rows; ``merge_view`` patches
the partial reply into a copy of its cached view.  It computes on the device its view
lives on, on the same stream as the master, so the device runs its
gradient after the update that produced its view.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from ..obs import trace
from .clock import VirtualClock
from .faults import FaultInjector
from .mailbox import GradMsg, Mailbox
from .master import Master


class TurnGate:
    """Round-robin message-schedule pin (``ClusterConfig.pin_schedule``).

    Worker ``wid`` may push only when ``turn % n == wid`` and advances the
    turn after its push completes, so the mailbox sees the exact sequence
    0, 1, ..., n-1, 0, 1, ... regardless of thread scheduling.  This makes
    live-mode runs schedule-deterministic."""

    def __init__(self, n: int, stop: threading.Event):
        self.n = n
        self.stop = stop
        self._turn = 0
        self._cond = threading.Condition()

    def acquire(self, wid: int) -> bool:
        with self._cond:
            while self._turn % self.n != wid:
                if self.stop.is_set():
                    return False
                self._cond.wait(timeout=0.05)
        return True

    def advance(self):
        with self._cond:
            self._turn += 1
            self._cond.notify_all()


class Worker(threading.Thread):
    def __init__(self, wid: int, *, master: Master, mailbox: Mailbox,
                 grad_fn: Callable, next_batch: Callable,
                 stop: threading.Event, mode: str,
                 init_view: tuple[Any, int],
                 clock: VirtualClock | None = None,
                 draw: Callable[[int], float] | None = None,
                 now_fn: Callable[[], float] | None = None,
                 time_scale: float = 1e-3,
                 injector: FaultInjector | None = None,
                 telemetry: bool = True, rpc_timeout: float = 120.0,
                 hot_rows: tuple[int, int] | None = None,
                 merge_view: Callable | None = None,
                 gate: TurnGate | None = None,
                 pipeline_depth: int = 0):
        super().__init__(name=f"ps-worker-{wid}", daemon=True)
        self.wid = wid
        self.master = master
        self.mailbox = mailbox
        self.grad_fn = grad_fn
        self.next_batch = next_batch
        self.stop = stop
        self.mode = mode
        self.clock = clock
        self.draw = draw
        self.now_fn = now_fn or (lambda: 0.0)
        self.time_scale = time_scale
        self.injector = injector
        self.telemetry = telemetry
        self.rpc_timeout = rpc_timeout
        # the (r0, r1) flat-row range this worker declares hot, and the
        # merge of a partial reply (set together by the runtime; a master
        # that cannot honour the range replies with a full view)
        self.hot_rows = hot_rows if merge_view is not None else None
        self.merge_view = merge_view
        self.gate = gate
        # pull-ahead: up to this many pushes stay in flight (live modes;
        # deterministic mode serializes through the virtual clock and
        # always runs depth 0)
        self.pipeline_depth = (0 if mode == "deterministic"
                               else max(0, pipeline_depth))
        self._pending: deque[GradMsg] = deque()
        self._view, self._view_step = init_view
        self.error: BaseException | None = None
        self.grads_sent = 0

    # -- thread entry ----------------------------------------------------
    def run(self):
        try:
            if self.mode == "deterministic":
                self._run_deterministic()
            else:
                self._run_live()
        except BaseException as e:  # noqa: BLE001 - reported by run_cluster
            self.error = e
            self.stop.set()
            if self.clock is not None:
                self.clock.stop()

    def _grad(self, batch):
        tg = time.perf_counter() if trace.enabled else 0.0
        grad = self.grad_fn(self._view, batch)
        if trace.enabled:
            trace.complete("grad", "worker", tg, time.perf_counter() - tg)
        return grad

    def _msg(self, grad, t_send: float) -> GradMsg:
        return GradMsg(self.wid, grad,
                       self._view if (self.telemetry and grad is not None)
                       else None,
                       self._view_step, t_send,
                       rows=self.hot_rows if grad is None else None)

    # -- pipelined RPC halves (pipeline_depth > 0) -----------------------
    def _post(self, grad, t_send: float) -> GradMsg | None:
        """Enqueue one push without waiting for its reply (the pull-ahead
        half-RPC); returns the in-flight message, or None on shutdown."""
        msg = self._msg(grad, t_send)
        if not self.mailbox.put(msg, self.stop):
            return None
        if trace.enabled:
            trace.instant("rpc_post", "worker", worker=self.wid)
        return msg

    def _await(self, msg: GradMsg) -> bool:
        """Settle one in-flight push: wait for its reply and adopt the
        fresher view."""
        t0 = time.perf_counter() if trace.enabled else 0.0
        reply = msg.wait_reply(self.rpc_timeout)
        if trace.enabled:
            trace.complete("rpc_await", "worker", t0,
                           time.perf_counter() - t0)
        if reply is None:
            return False
        self._view, self._view_step = reply.view, reply.step
        if msg.grad is not None:
            self.grads_sent += 1
        return True

    def _drain_pending(self) -> bool:
        ok = True
        while self._pending:
            ok = self._await(self._pending.popleft()) and ok
        return ok

    # -- one RPC ---------------------------------------------------------
    def _push(self, grad, t_send: float) -> bool:
        msg = self._msg(grad, t_send)
        t0 = time.perf_counter() if trace.enabled else 0.0
        if not self.mailbox.put(msg, self.stop):
            return False
        reply = msg.wait_reply(self.rpc_timeout)
        if trace.enabled:
            # the fused push-pull round trip: enqueue + queueing delay +
            # master service time, as seen from this worker
            trace.complete("rpc", "worker", t0, time.perf_counter() - t0,
                           pull_only=grad is None)
        if reply is None:
            return False
        if reply.rows is not None:
            # a partial (hot-row) view: patch the declared rows into a
            # copy of the cached view
            self._view = self.merge_view(self._view, reply.view)
            self._view_step = reply.step
        else:
            self._view, self._view_step = reply.view, reply.step
        if grad is not None:
            self.grads_sent += 1
        return True

    # -- deterministic mode ---------------------------------------------
    def _run_deterministic(self):
        counter = 0
        while True:
            t = self.clock.acquire(self.wid)
            if t is None:
                return
            ok = False
            try:
                if (not self.stop.is_set()
                        and self.master.applied < self.master.total):
                    batch = self.next_batch(self.wid, counter)
                    counter += 1
                    ok = self._push(self._grad(batch), t)
            finally:
                if ok:
                    stall = (self.injector.stall(self.wid)
                             if self.injector is not None else 0.0)
                    self.clock.release(self.wid, extra=stall)
                else:
                    self.clock.withdraw(self.wid)
            if not ok:
                return

    # -- paced / free modes ----------------------------------------------
    def _run_live(self):
        try:
            self._live_loop()
        except BaseException:
            # settle best-effort, but a secondary drain failure (e.g.
            # wait_reply timing out against an already-wedged master)
            # must not replace the loop's own error in worker.error
            try:
                self._drain_pending()
            except BaseException:  # noqa: BLE001 - root cause wins
                self._pending.clear()
            raise
        else:
            # settle any still-in-flight pull-ahead pushes so applied
            # grads are counted (end-of-run rejections resolve to None
            # and the master's shutdown path unblocks stragglers)
            self._drain_pending()

    def _live_loop(self):
        counter = 0
        while (not self.stop.is_set()
               and self.master.applied < self.master.total):
            stall = 0.0
            if self.injector is not None:
                back = self.injector.offline_until(self.wid,
                                                   self.master.step)
                if back is not None:
                    if trace.enabled:
                        trace.instant("dropout", "faults", worker=self.wid,
                                      back_step=back)
                    # an offline worker abandons its pipeline first: the
                    # in-flight pushes settle, then the stale view is
                    # discarded by the rejoin pull
                    self._drain_pending()
                    if not self._await_rejoin(back):
                        return
                    if trace.enabled:
                        trace.instant("rejoin", "faults", worker=self.wid)
                    # rejoin: stale view discarded, pull-only request
                    if not self._push(None, self.now_fn()):
                        return
                    continue
                stall = self.injector.stall(self.wid)
            dt = stall + (self.draw(self.wid) if self.mode == "paced"
                          else 0.0)
            if dt > 0.0 and self.stop.wait(dt * self.time_scale):
                return
            if self.gate is not None and not self.gate.acquire(self.wid):
                return
            try:
                batch = self.next_batch(self.wid, counter)
                counter += 1
                grad = self._grad(batch)
                if self.pipeline_depth == 0:
                    ok = self._push(grad, self.now_fn())
                else:
                    # pull-ahead: post now, settle the OLDEST in-flight
                    # push only once more than `depth` are outstanding —
                    # the RPC round trip hides behind the next gradient
                    msg = self._post(grad, self.now_fn())
                    ok = msg is not None
                    if ok:
                        self._pending.append(msg)
            finally:
                if self.gate is not None:
                    self.gate.advance()
            while ok and len(self._pending) > self.pipeline_depth:
                ok = self._await(self._pending.popleft())
            if not ok:
                return

    def _await_rejoin(self, back_step: int) -> bool:
        while not self.stop.is_set() and self.master.step < back_step:
            if self.master.applied >= self.master.total:
                return False
            self.stop.wait(0.002)
        return not self.stop.is_set()
