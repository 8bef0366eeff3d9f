"""Lock-free per-thread span tracer with Chrome-trace/Perfetto export.

The port's own copy of the JAX package's tracer (``repro_torch`` imports
nothing of ``repro``).  The cluster's hot path processes a message in
microseconds of host time, so the tracer's contract is asymmetric:

* **disabled** (the default) it must be NEAR-FREE: every call site is
  guarded by the module-level ``enabled`` bool — one attribute read and
  a branch, no locks, no allocation, no time syscall.
* **enabled** it must not reorder or serialize the shard/worker threads:
  every thread writes to its OWN ring buffer (created lazily; the global
  registry lock is taken once per thread lifetime, never per event).
  Rings are bounded and drop-oldest — a long run keeps the trace's tail,
  the export records how much was dropped.

Event model (a subset of the Chrome trace-event format, so an exported
file opens directly in ``ui.perfetto.dev`` or ``chrome://tracing``):

* **complete spans** (``ph="X"``) — begin/end pairs via ``begin()`` /
  ``end()`` (per-thread stack) or one ``complete()`` call when the
  caller already measured the interval (the serve loop reuses its
  ``busy_s`` timing, paying zero extra clock reads);
* **instant events** (``ph="i"``) — point markers (fault injections);
* **counters** (``ph="C"``) — sampled value tracks (mailbox depth,
  per-shard busy time), emitted by the off-hot-path snapshot publisher
  (``repro_torch.obs.metrics.SnapshotPublisher``).

Timestamps are ``time.perf_counter`` seconds relative to the
``enable()`` epoch, exported as microseconds.  Thread names (the
runtime names its threads ``ps-master`` / ``ps-shard-N`` /
``ps-worker-N``) become Perfetto track names via ``thread_name``
metadata events.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

# Module-level no-op guard.  Call sites MUST read this through the
# module (``trace.enabled``), never ``from ... import enabled`` (which
# would freeze the value at import time).
enabled = False

DEFAULT_CAPACITY = 65536      # events per thread ring

_epoch = 0.0
_capacity = DEFAULT_CAPACITY
_gen = 0                      # bumped by enable(): invalidates old rings
_rings: list["_Ring"] = []    # all live rings; guarded by _reg_lock
_reg_lock = threading.Lock()
_tls = threading.local()


class _Ring:
    """One thread's bounded drop-oldest event buffer.

    Single writer (the owning thread), so appends are lock-free: the
    write index only grows, slot ``idx % capacity`` is overwritten, and
    ``idx - capacity`` events (if positive) have been dropped.  The
    exporter reads from another thread; a torn read of the in-flight
    slot is acceptable for observability (events are immutable tuples,
    so a slot is either the old event or the new one, never garbage).
    """

    __slots__ = ("events", "idx", "gen", "tid", "name", "stack")

    def __init__(self, capacity: int, gen: int, tid: int, name: str):
        self.events: list = [None] * capacity
        self.idx = 0
        self.gen = gen
        self.tid = tid
        self.name = name
        self.stack: list = []          # open begin() frames

    def push(self, ev: tuple):
        self.events[self.idx % len(self.events)] = ev
        self.idx += 1

    @property
    def dropped(self) -> int:
        return max(0, self.idx - len(self.events))


def _ring() -> _Ring:
    r = getattr(_tls, "ring", None)
    if r is None or r.gen != _gen:
        t = threading.current_thread()
        r = _Ring(_capacity, _gen, t.ident or 0, t.name)
        _tls.ring = r
        with _reg_lock:                # once per thread per enable()
            _rings.append(r)
    return r


# -- lifecycle --------------------------------------------------------------
def enable(capacity: int = DEFAULT_CAPACITY):
    """Start a fresh trace: clears previous buffers, re-zeros the clock."""
    global enabled, _epoch, _capacity, _gen
    with _reg_lock:
        _rings.clear()
    _gen += 1
    _capacity = int(capacity)
    _epoch = time.perf_counter()
    enabled = True


def disable():
    """Stop recording (buffers are kept for a later ``export()``)."""
    global enabled
    enabled = False


# -- recording --------------------------------------------------------------
# Events are tuples: (ph, name, cat, t0_seconds, dur_seconds|None, args|None)

def begin(name: str, cat: str):
    """Open a span on this thread's stack (close with ``end()``)."""
    _ring().stack.append((name, cat, time.perf_counter()))


def end(**args):
    """Close the innermost ``begin()`` span."""
    t1 = time.perf_counter()
    r = _ring()
    if not r.stack:
        return
    name, cat, t0 = r.stack.pop()
    r.push(("X", name, cat, t0, t1 - t0, args or None))


def complete(name: str, cat: str, t0: float, dur: float, **args):
    """Record an already-measured interval (perf_counter seconds)."""
    _ring().push(("X", name, cat, t0, max(dur, 0.0), args or None))


def instant(name: str, cat: str, **args):
    _ring().push(("i", name, cat, time.perf_counter(), None, args or None))


def counter(track: str, value: float):
    """One sample on a Perfetto counter track."""
    _ring().push(("C", track, None, time.perf_counter(), None,
                  {"value": float(value)}))


@contextlib.contextmanager
def span(name: str, cat: str, **args):
    """Context-manager span — for set-up / bench phases, NOT the
    per-message hot path (it allocates a frame even when guarded)."""
    if not enabled:
        yield
        return
    begin(name, cat)
    try:
        yield
    finally:
        end(**args)


# -- export -----------------------------------------------------------------
def export(path: str | None = None) -> dict:
    """Snapshot all rings into one Chrome-trace JSON object.

    Safe to call while threads are still tracing (a live run's partial
    trace) — the snapshot is per-ring consistent up to a possible torn
    tail slot.  When ``path`` is given the object is also written there.
    """
    pid = os.getpid()
    with _reg_lock:
        rings = list(_rings)
    events: list[dict] = []
    dropped = 0
    for r in rings:
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": r.tid, "args": {"name": r.name}})
        dropped += r.dropped
        cap = len(r.events)
        idx = r.idx                       # snapshot the write index
        for j in range(max(0, idx - cap), idx):
            ev = r.events[j % cap]
            if ev is None:
                continue
            ph, name, cat, t0, dur, args = ev
            rec = {"ph": ph, "name": name, "pid": pid, "tid": r.tid,
                   "ts": (t0 - _epoch) * 1e6}
            if cat is not None:
                rec["cat"] = cat
            if ph == "X":
                rec["dur"] = dur * 1e6
            elif ph == "i":
                rec["s"] = "t"            # thread-scoped instant
            if args:
                rec["args"] = args
            events.append(rec)
    events.sort(key=lambda e: e.get("ts", -1.0))
    obj = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_events": dropped,
                      "clock": "perf_counter_us_since_enable"},
    }
    if path:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)
    return obj


def validate_chrome_trace(obj) -> list[str]:
    """Schema check for an exported trace (the CI smoke contract).

    Returns a list of human-readable problems; empty == valid.  Checks
    the subset of the Chrome trace-event format this tracer emits, plus
    non-emptiness (a trace with zero spans is a wiring regression, not
    a valid trace).
    """
    errs: list[str] = []
    if not isinstance(obj, dict):
        return [f"trace must be a JSON object, got {type(obj).__name__}"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    spans = 0
    for n, e in enumerate(evs):
        if not isinstance(e, dict):
            errs.append(f"event #{n}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M"):
            errs.append(f"event #{n}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errs.append(f"event #{n}: missing name")
        if "tid" not in e or "pid" not in e:
            errs.append(f"event #{n}: missing pid/tid")
        if ph == "M":
            continue
        if not isinstance(e.get("ts"), (int, float)):
            errs.append(f"event #{n}: missing numeric ts")
        if ph == "X":
            spans += 1
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event #{n}: X event needs dur >= 0")
        if ph == "C":
            args = e.get("args")
            if not (isinstance(args, dict) and args and all(
                    isinstance(v, (int, float)) for v in args.values())):
                errs.append(f"event #{n}: C event needs numeric args")
    if spans == 0:
        errs.append("trace contains no complete spans")
    return errs
