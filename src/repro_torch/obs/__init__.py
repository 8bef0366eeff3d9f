"""Cluster observability: lock-free tracing + typed metrics.

The port's own copy of the JAX package's ``obs`` (no import of it):

* ``repro_torch.obs.trace`` — per-thread ring-buffer span tracer with a
  Chrome-trace/Perfetto JSON exporter (open a ``--trace`` artifact in
  ``ui.perfetto.dev``).  Disabled it costs one module-attribute read
  per call site; enabled it never takes a lock on the hot path.
* ``repro_torch.obs.metrics`` — counters / gauges / fixed-bucket
  histograms (staleness, gap, drained-batch k, mailbox depth, master
  busy time) with a background ``SnapshotPublisher`` that samples gauges
  off the hot path and mirrors them onto Perfetto counter tracks.

Wired through the threaded cluster (``repro_torch.cluster``) and its
CLI (``--trace`` / ``--metrics-out``); ``core.metrics.History.observer``
takes ``history_observer``.
"""
from . import trace
from .metrics import (DEPTH_EDGES, DRAIN_K_EDGES, GAP_EDGES,
                      STALENESS_EDGES, Counter, Gauge, Histogram,
                      MetricsRegistry, SnapshotPublisher,
                      history_observer, serve_instruments)
from .trace import validate_chrome_trace

__all__ = [
    "trace", "validate_chrome_trace", "MetricsRegistry", "Counter",
    "Gauge", "Histogram", "SnapshotPublisher", "history_observer",
    "serve_instruments", "STALENESS_EDGES", "GAP_EDGES", "DRAIN_K_EDGES",
    "DEPTH_EDGES",
]
