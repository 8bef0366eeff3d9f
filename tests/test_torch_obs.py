"""The port's observability layer against the JAX package's.

``repro_torch.obs`` is the port's own copy of ``repro.obs``: a trace it
exports passes its own schema check (and the JAX package's), and the
metrics registry fed the same recorded inputs gives the same JSON
snapshot, instrument for instrument.
"""
import json
import threading

import numpy as np

from repro import obs as jobs

from repro_torch import obs
from repro_torch.obs import trace

ROWS = [dict(time=0.5 * j, step=j + 1, worker=j % 3, lag=(7 * j) % 11,
             gap=10.0 ** (-6 + (j % 9)), grad_norm=0.5 + j % 4,
             staleness=float("nan") if j % 2 else float(j % 5))
        for j in range(40)]


def _feed(pkg):
    reg = pkg.MetricsRegistry()
    observe = pkg.history_observer(reg)
    for row in ROWS:
        observe(**row)
    mx = pkg.serve_instruments(reg)
    for k in (1, 3, 8, 8, 2, 5):
        mx.drain_k.observe(k)
    mx.pulls.add(2)
    mx.overflow.add(1)
    mx.slab_rows_streamed.add(48)
    mx.slab_rows_total.add(128)
    reg.gauge("mailbox_depth", lambda: 3)
    reg.histogram("depth", pkg.DEPTH_EDGES).observe(17)
    return reg


def test_metrics_snapshot_equals_the_jax_registry():
    port, ref = _feed(obs), _feed(jobs)
    assert port.names() == ref.names()
    assert json.dumps(port.snapshot(), sort_keys=True) == \
        json.dumps(ref.snapshot(), sort_keys=True)
    for name, edges in (("staleness", obs.STALENESS_EDGES),
                        ("gap", obs.GAP_EDGES),
                        ("drain_k", obs.DRAIN_K_EDGES)):
        for q in (0.5, 0.9, 0.99):
            assert port.histogram(name, edges).quantile(q) == \
                ref.histogram(name, edges).quantile(q)


def test_metrics_to_json(tmp_path):
    reg = _feed(obs)
    out = reg.to_json(str(tmp_path / "m.json"), extra={"series": {}})
    disk = json.loads((tmp_path / "m.json").read_text())
    assert disk["metrics"]["updates"]["value"] == len(ROWS)
    assert disk["metrics"]["sent_staleness"]["count"] == 20  # NaNs dropped
    assert set(disk) == set(out)


def test_trace_export_passes_its_schema_check(tmp_path):
    trace.enable()
    try:
        def work(i):
            with trace.span("phase", "test", i=i):
                trace.instant("mark", "test", i=i)
            trace.begin("outer", "test")
            trace.end(k=i)
            trace.counter("depth", i)

        threads = [threading.Thread(target=work, args=(i,), name=f"t{i}")
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        trace.disable()
    obj = trace.export(str(tmp_path / "trace.json"))
    assert obs.validate_chrome_trace(obj) == []
    assert jobs.validate_chrome_trace(obj) == []
    spans = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == 6
    names = {e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M"}
    assert names == {"t0", "t1", "t2"}
    assert json.loads((tmp_path / "trace.json").read_text()) == obj


def test_schema_check_rejects_what_the_jax_check_rejects():
    bad = [{"traceEvents": []},
           {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1,
                             "ts": 0.0, "dur": -1.0}]},
           {"traceEvents": [{"ph": "Q", "name": "a", "pid": 1, "tid": 1}]},
           []]
    for obj in bad:
        assert obs.validate_chrome_trace(obj) == \
            jobs.validate_chrome_trace(obj) != []


def test_publisher_samples_off_the_hot_path():
    reg = obs.MetricsRegistry()
    box = {"v": 0}
    pub = obs.SnapshotPublisher({"depth": lambda: box["v"]},
                                interval=0.001, registry=reg)
    pub.start()
    box["v"] = 4
    pub.stop()
    assert not pub.is_alive()
    series = pub.series()["depth"]
    assert series and series[-1][1] == 4.0
    assert reg.gauge("depth").value == 4.0
    assert np.isfinite(series[0][0])
