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

The row-sharded master's fan-out (``FanoutMailbox``, ``ShardMsg``) and
hot-row pulls come with their slices (ROADMAP.md).
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
    the master step it was issued at (the worker's next ``pull_step``)."""
    view: Any
    step: int


class GradMsg:
    """One worker->master message.

    ``grad is None`` marks a pull-only request (a rejoining worker asking
    for fresh parameters without contributing an update).
    """

    __slots__ = ("worker_id", "grad", "view", "view_step", "t_send",
                 "_event", "_reply")

    def __init__(self, worker_id: int, grad: Any, view: Any,
                 view_step: int, t_send: float):
        self.worker_id = worker_id
        self.grad = grad
        self.view = view              # params the gradient was computed on
        self.view_step = view_step    # master step the view was issued at
        self.t_send = t_send          # virtual (det/paced) or wall time
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
