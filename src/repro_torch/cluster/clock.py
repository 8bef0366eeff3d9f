"""Virtual clock for the cluster's deterministic mode.

Replays the discrete-event engine's scheduling exactly: a min-heap of
``(event_time, worker_id)`` drives which worker may proceed, and the
gamma execution-time sampler is owned by the clock so its draws happen in
the engine's order (workers 0..n-1 at init, then one draw per processed
event).  Worker threads ``acquire`` their turn — blocking until their
event is the global minimum — process one gradient end-to-end, and
``release`` to schedule their next event.

Execution is therefore fully serialized (one in-flight event), which is
the point: deterministic mode trades parallelism for a step-for-step
cross-validation of the threaded runtime against ``run_simulation``.
"""
from __future__ import annotations

import heapq
import threading
from typing import Callable


class VirtualClock:
    def __init__(self, draw: Callable[[int], float], num_workers: int):
        self._draw = draw
        self._heap: list[tuple[float, int]] = []
        self._cond = threading.Condition()
        self._holder: int | None = None
        self._stopped = False
        self.now = 0.0
        # engine order: one initial draw per worker, 0..n-1
        for i in range(num_workers):
            heapq.heappush(self._heap, (draw(i), i))

    def acquire(self, worker_id: int) -> float | None:
        """Block until this worker's event is the minimum and no other
        worker holds the clock; returns the event's virtual time (None on
        shutdown)."""
        with self._cond:
            while True:
                if self._stopped:
                    return None
                if (self._holder is None and self._heap
                        and self._heap[0][1] == worker_id):
                    t, _ = heapq.heappop(self._heap)
                    self._holder = worker_id
                    self.now = t
                    return t
                self._cond.wait(timeout=0.05)

    def release(self, worker_id: int, extra: float = 0.0):
        """Schedule the worker's next event at now + gamma draw (+ any
        injected stall time) and hand the clock back."""
        with self._cond:
            assert self._holder == worker_id
            heapq.heappush(self._heap,
                           (self.now + self._draw(worker_id) + extra,
                            worker_id))
            self._holder = None
            self._cond.notify_all()

    def withdraw(self, worker_id: int):
        """Remove a finished worker so the remaining ones can still reach
        the heap minimum (used at shutdown)."""
        with self._cond:
            self._heap = [(t, i) for t, i in self._heap if i != worker_id]
            heapq.heapify(self._heap)
            if self._holder == worker_id:
                self._holder = None
            self._cond.notify_all()

    def stop(self):
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
