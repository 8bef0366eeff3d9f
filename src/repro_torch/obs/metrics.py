"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of the JAX package's registry: the same instruments,
bucket edges and JSON snapshot, so the two packages' metrics compare
name for name.  Built for the same asymmetric budget as the tracer: instrument updates
happen on cluster threads (master, shard servers, workers), so every
instrument is **lock-free single-writer-per-thread** — a writer touches
only its own cell (keyed by thread id; CPython dict item assignment is
atomic under the GIL), and readers merge the cells at snapshot time.
The snapshot path (the background ``SnapshotPublisher``, the end-of-run
JSON dump) therefore never contends with the drain/apply hot path.

The paper's claims are *distributional* — DANA tames the staleness
distribution that momentum amplifies — so the first-class instruments
are histograms with fixed bucket edges chosen for the quantities the
runtime actually measures:

* ``STALENESS_EDGES`` — gradient staleness / lag in master updates
  (the paper's tau; the x-axis of its staleness figures);
* ``GAP_EDGES`` — the parameter gap ``G`` and normalized gap ``G*``
  (paper App. B.3), geometric because gaps span decades;
* ``DRAIN_K_EDGES`` — drained-batch size (the coalescing histogram);
* ``DEPTH_EDGES`` — mailbox depth samples.

``history_observer`` adapts a registry to ``History.record`` so the
threaded cluster and the discrete-event engine feed the SAME instruments
from their existing telemetry choke point — backend-comparable metrics
with no extra device traffic.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time

from . import trace

STALENESS_EDGES = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
GAP_EDGES = tuple(10.0 ** e for e in range(-8, 5))       # 1e-8 .. 1e4
DRAIN_K_EDGES = (1, 2, 4, 8, 16, 32, 64)
DEPTH_EDGES = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


class Counter:
    """Monotone float counter; ``add`` is lock-free (per-thread cells)."""

    __slots__ = ("name", "_cells")

    def __init__(self, name: str):
        self.name = name
        self._cells: dict[int, float] = {}

    def add(self, v: float = 1.0):
        c = self._cells
        tid = threading.get_ident()
        c[tid] = c.get(tid, 0.0) + v

    @property
    def value(self) -> float:
        return float(sum(self._cells.values()))

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Point-in-time value: ``set`` by its owner, or pulled through a
    ``fn`` callable at read time (how mailbox depth / busy_s are sampled
    without the owner pushing anything)."""

    __slots__ = ("name", "_v", "_fn")

    def __init__(self, name: str, fn=None):
        self.name = name
        self._v = 0.0
        self._fn = fn

    def set(self, v: float):
        self._v = float(v)

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram (bucket b counts x <= edges[b]; the last
    bucket is the +inf overflow).  ``observe`` is lock-free: each thread
    owns a private counts list; snapshots merge."""

    __slots__ = ("name", "edges", "_cells")

    def __init__(self, name: str, edges):
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"bucket edges must be sorted/unique, "
                             f"got {edges}")
        self.name = name
        self.edges = edges
        # tid -> [counts (len(edges)+1), sum, count, min, max]
        self._cells: dict[int, list] = {}

    def observe(self, x: float):
        x = float(x)
        if x != x:                      # NaN: not a sample
            return
        tid = threading.get_ident()
        cell = self._cells.get(tid)
        if cell is None:
            cell = [[0] * (len(self.edges) + 1), 0.0, 0, math.inf,
                    -math.inf]
            self._cells[tid] = cell
        cell[0][bisect.bisect_left(self.edges, x)] += 1
        cell[1] += x
        cell[2] += 1
        cell[3] = min(cell[3], x)
        cell[4] = max(cell[4], x)

    # -- merged views ----------------------------------------------------
    def _merged(self):
        counts = [0] * (len(self.edges) + 1)
        total, n, lo, hi = 0.0, 0, math.inf, -math.inf
        for cell in list(self._cells.values()):
            for b, c in enumerate(cell[0]):
                counts[b] += c
            total += cell[1]
            n += cell[2]
            lo = min(lo, cell[3])
            hi = max(hi, cell[4])
        return counts, total, n, lo, hi

    @property
    def count(self) -> int:
        return self._merged()[2]

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper edge of the bucket holding
        the q-th sample; the overflow bucket reports the observed max)."""
        counts, _, n, _, hi = self._merged()
        if n == 0:
            return float("nan")
        rank = q * n
        acc = 0
        for b, c in enumerate(counts):
            acc += c
            if acc >= rank and c:
                return self.edges[b] if b < len(self.edges) else hi
        return hi

    def nonzero_buckets(self) -> int:
        return sum(1 for c in self._merged()[0] if c)

    def snapshot(self) -> dict:
        counts, total, n, lo, hi = self._merged()
        labels = [f"le_{e:g}" for e in self.edges] + ["inf"]
        return {
            "type": "histogram",
            "buckets": dict(zip(labels, counts)),
            "count": n,
            "sum": total,
            "mean": (total / n) if n else float("nan"),
            "min": lo if n else float("nan"),
            "max": hi if n else float("nan"),
            "p50": self.quantile(0.5),
            "p90": self.quantile(0.9),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named instruments + JSON snapshotting.

    Instrument creation takes a lock (it happens at wiring time, not on
    the hot path); asking for an existing name returns the same object,
    so independent wiring sites share instruments by name.
    """

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = kind(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(inst).__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, fn=None) -> Gauge:
        g = self._get(name, Gauge)
        if fn is not None:
            g._fn = fn
        return g

    def histogram(self, name: str, edges) -> Histogram:
        return self._get(name, Histogram, edges)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> dict:
        with self._lock:
            insts = dict(self._instruments)
        return {name: inst.snapshot() for name, inst in sorted(
            insts.items())}

    def to_json(self, path: str, extra: dict | None = None):
        obj = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
               "metrics": self.snapshot()}
        if extra:
            obj.update(extra)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f, indent=1, default=float)
        return obj


# -- backend-shared wiring ---------------------------------------------------
def history_observer(reg: MetricsRegistry):
    """Adapter feeding the registry from ``History.record`` rows — the one
    telemetry choke point both backends (threaded cluster, discrete-event
    engine) already flow through, so their metrics are comparable by
    construction.  Lag is the paper's gradient staleness tau; the
    sent-snapshot staleness series (when the algorithm has one) gets its
    own histogram."""
    updates = reg.counter("updates")
    h_lag = reg.histogram("staleness", STALENESS_EDGES)
    h_sent = reg.histogram("sent_staleness", STALENESS_EDGES)
    h_gap = reg.histogram("gap", GAP_EDGES)
    h_ngap = reg.histogram("normalized_gap", GAP_EDGES)

    def observe(*, lag, gap, grad_norm, staleness=float("nan"), **_):
        updates.add(1.0)
        h_lag.observe(lag)
        h_sent.observe(staleness)          # NaN -> dropped
        h_gap.observe(gap)
        if grad_norm > 0.0:
            h_ngap.observe(gap / grad_norm)

    return observe


def serve_instruments(reg: MetricsRegistry):
    """The serve-loop-side instruments (drained-batch size, pulls,
    overflow, memory-tier traffic) as one attribute bundle; every shard
    server shares it (instruments are per-thread-cell lock-free).

    The memory-tier pair makes the prefetch kernel's 2N->2u claim
    observable: per fused apply, ``slab_rows_streamed`` counts the slab
    rows the scalar-prefetch lowering actually moves (2 streams — read +
    write — per unique sender per slab) while ``slab_rows_total`` counts
    what the full-slab kernel would have moved (2 streams per WORKER per
    slab).  ``pull_rows`` counts view rows served on the pull path, so
    hot-row (partial-range) pulls show up as fewer rows per pull."""

    class _ServeMetrics:
        __slots__ = ("drain_k", "pulls", "overflow",
                     "slab_rows_streamed", "slab_rows_total", "pull_rows",
                     "tele_dropped")

    m = _ServeMetrics()
    m.drain_k = reg.histogram("drain_k", DRAIN_K_EDGES)
    m.pulls = reg.counter("pulls")
    m.overflow = reg.counter("overflow_rejected")
    m.slab_rows_streamed = reg.counter("slab_rows_streamed")
    m.slab_rows_total = reg.counter("slab_rows_total")
    m.pull_rows = reg.counter("pull_rows")
    # fan-out telemetry groups that finished without flushing a History
    # row (a shard rejected the message, or shard 0's meta never landed):
    # their accumulated d2/g2 partials are dropped — counted, not silent
    m.tele_dropped = reg.counter("telemetry_dropped")
    return m


class SnapshotPublisher(threading.Thread):
    """Background sampler: reads gauge sources (mailbox depth, per-shard
    busy seconds) every ``interval`` seconds OFF the hot path, keeps a
    bounded time series, and mirrors each sample onto a Perfetto counter
    track when tracing is enabled.

    ``sources`` maps track name -> zero-arg callable.  Sources must be
    lock-free reads (plain attribute/int reads) — that is the mailbox
    depth contract (``Mailbox.depth``).  Failures of a source are
    swallowed: sampling must never take down a run.
    """

    MAX_SAMPLES = 100_000            # bounded memory, drop-oldest

    def __init__(self, sources: dict, *, interval: float = 0.005,
                 registry: MetricsRegistry | None = None):
        super().__init__(name="obs-publisher", daemon=True)
        self.sources = dict(sources)
        self.interval = float(interval)
        self.samples: list[tuple] = []    # (t, {track: value})
        self._dropped = 0
        self._halt = threading.Event()
        if registry is not None:
            for track, fn in self.sources.items():
                registry.gauge(track, fn)

    def sample_once(self):
        row = {}
        for track, fn in self.sources.items():
            try:
                row[track] = float(fn())
            except Exception:  # noqa: BLE001 - observation must not kill
                continue
        if trace.enabled:
            for track, v in row.items():
                trace.counter(track, v)
        self.samples.append((time.perf_counter(), row))
        if len(self.samples) > self.MAX_SAMPLES:
            del self.samples[: self.MAX_SAMPLES // 10]
            self._dropped += self.MAX_SAMPLES // 10

    def run(self):
        while not self._halt.wait(self.interval):
            self.sample_once()

    def stop(self):
        self._halt.set()
        if self.is_alive():
            self.join(timeout=5.0)
        self.sample_once()               # final post-run sample

    def series(self) -> dict:
        """{track: [(t, value), ...]} for JSON artifacts."""
        out: dict[str, list] = {t: [] for t in self.sources}
        for t, row in self.samples:
            for track, v in row.items():
                out[track].append((t, v))
        return out
