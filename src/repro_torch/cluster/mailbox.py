"""Bounded gradient mailbox between worker threads and the master.

The mailbox is the cluster's only synchronization point on the hot path:
workers ``put`` gradient messages (blocking when the queue is full — the
back-pressure a real parameter server applies to fast workers), and the
master ``drain``s up to k messages at a time for a coalesced receive.

Each message doubles as its own reply slot: the push is a fused push-pull
RPC — the master answers with the post-update parameter view, exactly the
``receive`` -> ``send`` sequence of the discrete-event engine.  Because
the reply slot travels WITH the message, worker pull-ahead
(``ClusterConfig.pipeline_depth``) needs no protocol change: a worker
keeps up to ``depth`` pushes in flight simply by deferring
``wait_reply`` on their messages while it computes the next gradient.

For the row-sharded master (``cluster/sharded.py``) the same protocol
fans out: ``FanoutMailbox`` splits one worker message into S
``ShardMsg`` parts (each carrying only its shard's row slice of the
gradient and view) and a ``_ReplyGroup`` gathers the S shard replies
into the one ``Reply`` the worker waits on: the worker pushes a
gradient ONCE and never knows the master is sharded.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any

from ..obs import trace


@dataclasses.dataclass
class Reply:
    """Master's answer to one gradient push: the fresh parameter view and
    the master step it was issued at (the worker's next ``pull_step``).

    ``rows`` is None for a full view; a hot-row pull answered over only
    the requested row range carries that ``(r0, r1)`` back, and the
    worker patches the partial view into its copy."""
    view: Any
    step: int
    rows: Any = None


class GradMsg:
    """One worker->master message.

    ``grad is None`` marks a pull-only request (a rejoining worker asking
    for fresh parameters without contributing an update).  ``rows``
    (pull-only) is an optional ``(r0, r1)`` flat-row range the worker
    declares hot: the master may serve the view over just those rows
    (``Reply.rows`` echoes the range it honoured; masters whose send
    writes state fall back to the full view and leave it None).
    """

    __slots__ = ("worker_id", "grad", "view", "view_step", "t_send",
                 "rows", "_event", "_reply")

    def __init__(self, worker_id: int, grad: Any, view: Any,
                 view_step: int, t_send: float, rows=None):
        self.worker_id = worker_id
        self.grad = grad
        self.view = view              # params the gradient was computed on
        self.view_step = view_step    # master step the view was issued at
        self.t_send = t_send          # virtual (det/paced) or wall time
        self.rows = rows              # hot-row range of a pull-only request
        self._event = threading.Event()
        self._reply: Reply | None = None

    # -- reply slot ------------------------------------------------------
    def respond(self, reply: Reply | None):
        self._reply = reply
        self._event.set()

    def wait_reply(self, timeout: float | None = None) -> Reply | None:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"worker {self.worker_id}: no master reply in {timeout}s")
        return self._reply


class _ReplyGroup:
    """Gathers S shard replies into one worker-facing ``Reply``.

    The worker's view is the range-ordered tuple of the shards' view
    slices; the reply step is shard 0's (every shard applies every
    message; shard 0 is the canonical clock).  Any shard replying None
    (shutdown, overflow) fails the group.  Telemetry partial sums (each
    shard's ``sum d^2`` / ``sum g^2`` over its rows) add up here and go
    to the owner's callback once every shard has applied the message.
    """

    __slots__ = ("parent", "shards", "_lock", "_views", "_left", "_failed",
                 "_step0", "_rows_ok", "_tele_cb", "_drop_cb", "_tele_left",
                 "_tele_closed", "_d2", "_g2", "_meta")

    def __init__(self, parent: GradMsg, shards: int, tele_cb=None,
                 drop_cb=None):
        self.parent = parent
        self.shards = shards
        self._lock = threading.Lock()
        self._views = [None] * shards
        self._left = shards
        self._failed = False
        self._step0 = 0
        self._rows_ok = True         # every shard honoured its hot rows
        self._tele_cb = tele_cb
        self._drop_cb = drop_cb
        self._tele_left = shards
        self._tele_closed = False
        self._d2 = 0.0
        self._g2 = 0.0
        self._meta = None            # (worker, step, lag, t) of shard 0

    def shard_reply(self, sid: int, reply: Reply | None):
        with self._lock:
            if reply is None:
                self._failed = True
            else:
                self._views[sid] = reply.view
                if reply.rows is None:
                    self._rows_ok = False
                if sid == 0:
                    self._step0 = reply.step
            self._left -= 1
            done = self._left == 0
            failed = self._failed
        if done:
            # partial (hot rows) only when the parent asked for a range
            # AND every shard served its slice
            rows = (self.parent.rows
                    if self.parent.rows is not None and self._rows_ok
                    else None)
            self.parent.respond(None if failed else
                                Reply(view=tuple(self._views),
                                      step=self._step0, rows=rows))
            # shards that applied the message contributed their partials
            # before replying; shards that rejected it never will
            self._close_telemetry()

    def add_telemetry(self, sid: int, *, worker: int, step: int, lag: int,
                      t: float, d2: float, g2: float):
        with self._lock:
            self._d2 += d2
            self._g2 += g2
            if sid == 0:
                self._meta = (worker, step, lag, t)
            self._tele_left -= 1
            done = self._tele_left == 0
        if done:
            self._close_telemetry()

    def _close_telemetry(self):
        """Flush the partials (every shard contributed and shard 0's meta
        landed) or count the drop (the group finished with partials that
        can never complete).  Fires once; groups with no partials at all
        (pulls, telemetry off) are no drops."""
        with self._lock:
            if self._tele_closed:
                return
            self._tele_closed = True
            complete = self._tele_left == 0 and self._meta is not None
            started = self._tele_left < self.shards
            meta, d2, g2 = self._meta, self._d2, self._g2
        if complete:
            if self._tele_cb is not None:
                worker, step, lag, t = meta
                self._tele_cb(worker=worker, step=step, lag=lag, t=t,
                              d2=d2, g2=g2)
        elif started and self._drop_cb is not None:
            self._drop_cb()


class ShardMsg(GradMsg):
    """One shard's slice of a fanned-out worker message.  Responding
    feeds the shared ``_ReplyGroup``; the worker waits on the parent."""

    __slots__ = ("group", "sid")

    def __init__(self, worker_id: int, grad: Any, view: Any,
                 view_step: int, t_send: float, *, group: _ReplyGroup,
                 sid: int, rows=None):
        super().__init__(worker_id, grad, view, view_step, t_send,
                         rows=rows)
        self.group = group
        self.sid = sid

    def respond(self, reply: Reply | None):
        super().respond(reply)
        self.group.shard_reply(self.sid, reply)


class FanoutMailbox:
    """Worker-facing front of the sharded master: ``put`` fans one
    message out to the S shard mailboxes.  Gradients and telemetry views
    arrive as range-ordered tuples of row slices (the worker splits its
    packed gradient), so shard s takes element s.

    The fan-out is ATOMIC (one lock across the S enqueues): every shard
    sees the same arrival order, so the first ``total`` gradients, the
    set each shard applies before end-of-run truncation, are the same
    on every shard.  The lock covers only queue appends.

    ``ranges`` (the shards' static row ranges) lets a pull-only hot-row
    request fan out sliced: each part asks its shard for the local rows
    of the hot range within the shard's range (an empty intersection is
    a zero-row request).  ``full_fanout=True`` is the rebalancing wire:
    ranges move at run time, so every part carries the WHOLE packed
    gradient and each shard slices its current rows; hot-row slicing is
    off there."""

    def __init__(self, mailboxes: list["Mailbox"], tele_cb=None,
                 ranges=None, full_fanout: bool = False, drop_cb=None):
        self.mailboxes = list(mailboxes)
        self._tele_cb = tele_cb
        self._drop_cb = drop_cb
        self._lock = threading.Lock()
        self.ranges = (None if full_fanout or ranges is None
                       else tuple(ranges))
        self.full_fanout = full_fanout

    @property
    def depth(self) -> int:
        """Deepest shard queue: a lock-free read (``Mailbox.depth``)."""
        return max(mb.depth for mb in self.mailboxes)

    def __len__(self) -> int:
        return self.depth

    def put(self, msg: GradMsg, stop) -> bool:
        shards = len(self.mailboxes)
        group = _ReplyGroup(msg, shards, tele_cb=self._tele_cb,
                            drop_cb=self._drop_cb)
        if self.full_fanout:
            parts = [ShardMsg(msg.worker_id, msg.grad, msg.view,
                              msg.view_step, msg.t_send, group=group, sid=s)
                     for s in range(shards)]
        else:
            part_rows = [None] * shards
            if msg.rows is not None and self.ranges is not None:
                h0, h1 = msg.rows
                part_rows = [
                    (max(h0, s0) - s0, max(min(h1, s1), max(h0, s0)) - s0)
                    for s0, s1 in self.ranges]
            parts = [
                ShardMsg(msg.worker_id,
                         None if msg.grad is None else msg.grad[s],
                         None if msg.view is None else msg.view[s],
                         msg.view_step, msg.t_send, group=group, sid=s,
                         rows=part_rows[s])
                for s in range(shards)]
        with self._lock:
            for s, (part, mb) in enumerate(zip(parts, self.mailboxes)):
                if not mb.put(part, stop):
                    # shutdown mid-fan-out: shards 0..s-1 hold their
                    # parts (their servers or reject_pending answer them);
                    # fail the rest so the group can complete
                    for rest in parts[s:]:
                        rest.respond(None)
                    return False
        return True


class Mailbox:
    """Bounded FIFO with batched (coalescing) drain.

    Queue depth is mirrored into ``_depth``, a plain int updated only
    while the condition lock is already held for the queue mutation
    itself.  ``depth`` reads it WITHOUT the lock (int loads are atomic
    under the GIL), so the observability sampler — which polls depth at
    a few hundred Hz — never contends with the worker put / master drain
    hot path.
    """

    def __init__(self, capacity: int = 0):
        self._capacity = capacity          # 0 = unbounded
        self._q: collections.deque[GradMsg] = collections.deque()
        self._cond = threading.Condition()
        self._depth = 0                    # lock-free depth mirror

    @property
    def depth(self) -> int:
        """Current queue depth — lock-free, for sampler threads."""
        return self._depth

    def __len__(self) -> int:
        return self._depth

    def put(self, msg: GradMsg, stop: threading.Event) -> bool:
        """Enqueue; blocks while full.  Returns False if the cluster shut
        down before the message could be enqueued."""
        t0 = time.perf_counter() if trace.enabled else 0.0
        with self._cond:
            while self._capacity and len(self._q) >= self._capacity:
                if stop.is_set():
                    return False
                self._cond.wait(timeout=0.05)
            if stop.is_set():
                return False
            self._q.append(msg)
            self._depth = len(self._q)
            self._cond.notify_all()
        if trace.enabled:
            trace.complete("put", "mailbox", t0,
                           time.perf_counter() - t0, worker=msg.worker_id)
        return True

    def drain(self, max_k: int, stop: threading.Event,
              timeout: float = 0.05) -> list[GradMsg]:
        """Pop up to ``max_k`` queued messages (the coalesced receive
        window).  Blocks until at least one message is available or the
        stop flag is raised; never waits for the window to fill — when the
        queue is shallow the master degrades gracefully to k=1.  (The JAX
        package rounds k down to a power of two to bound its compiled
        variants; the CUDA kernel takes any k, so the port does not.)"""
        t0 = time.perf_counter() if trace.enabled else 0.0
        with self._cond:
            while not self._q:
                if stop.is_set():
                    return []
                self._cond.wait(timeout=timeout)
            k = min(max_k, len(self._q))
            out = [self._q.popleft() for _ in range(k)]
            self._depth = len(self._q)
            self._cond.notify_all()
        if trace.enabled:
            # the span is mostly WAIT time: in Perfetto, long drain spans
            # against short apply spans = an under-fed (idle) server
            trace.complete("drain", "mailbox", t0,
                           time.perf_counter() - t0, k=k)
        return out

    def drain_nowait(self) -> list[GradMsg]:
        with self._cond:
            out = list(self._q)
            self._q.clear()
            self._depth = 0
            self._cond.notify_all()
            return out
