"""The port's process backend (``repro_torch.cluster.procs``) on the CPU.

It mirrors the JAX package's ``tests/test_procs.py`` case by case and
holds the port against it:

* under a pinned round-robin schedule (``pin_schedule=True``) the
  process backend equals the port's own thread backend BIT FOR BIT at
  S = 1 and 2: the same worker/lag/step stream and the same final
  parameters (the elementwise family applies the same per-row message
  order); ga-asgd agrees to rtol 1e-5 / atol 1e-6;
* the same pinned run tracks the JAX package's pinned process run from
  the same numpy ``params0`` at rtol 1e-5 / atol 1e-6 (the ``TOL`` of
  ``test_torch_cluster.py``), with an identical event stream;
* a free run conserves its totals, a killed worker is named within
  60 s, the support matrix refuses with the JAX package's messages
  before any child starts, and a tensor handed to a child through a
  ring slot comes back unchanged;
* the regressions that ride along in the JAX file (stuck master,
  ``_ReplyGroup`` telemetry, the inclusive hot-row bound) on the port's
  thread backend, and the CLI with ``--backend process``.

Children run at one torch thread (the job carries the parent's count),
2 workers, small ``rpc_timeout``s; every run is bounded in time.  The
JAX package is imported only inside the test that compares with it, so
a child that unpickles this module's ``_KillerBatch`` stays light.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.cluster import ClusterConfig, FaultPlan, run_cluster
from repro_torch.cluster.mailbox import GradMsg, Reply, _ReplyGroup
from repro_torch.cluster.procs import (ShmFanout, ShmLayout, ShmMailbox,
                                       _attach, _ShmStop, alloc_rings)
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.flat import FlatSpec
from repro_torch.core.gamma import GammaModel
from repro_torch.core.types import (HyperParams, flatten_up_to, tree_leaves,
                                    tree_map)
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models.toy import ClassifierGradFn, make_classifier_fns

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DIMS = [8, 16, 4]
HP = dict(lr=0.05, momentum=0.9)
TOL = dict(rtol=1e-5, atol=1e-6)
TASK = ClassificationTask(dim=8, num_classes=4, batch_size=8, seed=3,
                          device="cpu")
GRAD_FN = ClassifierGradFn(DIMS)
EVAL_FN = make_classifier_fns(DIMS)[2](TASK.eval_batch(32))
_RUNS: dict = {}


def _params0(seed=1):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(DIMS[:-1], DIMS[1:])]


def _cfg(backend, *, shards=1, grads=24, workers=2, rpc_timeout=60.0,
         **kw):
    return ClusterConfig(num_workers=workers, total_grads=grads,
                         eval_every=8, mode="free",
                         exec_model=GammaModel(seed=5), backend=backend,
                         shards=shards, rpc_timeout=rpc_timeout,
                         device="cpu", **kw)


def _run(name, backend, **kw):
    stats = {}
    hist = run_cluster(make_algorithm(name, HyperParams(**HP)), GRAD_FN,
                       _params0(), TASK.batch, _cfg(backend, **kw), EVAL_FN,
                       stats_out=stats)
    return hist, stats


def _cached(name, backend, **kw):
    """One run per configuration in this module (the pinned runs are
    schedule-deterministic, so two tests may share one)."""
    key = (name, backend, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = _run(name, backend, **kw)
    return _RUNS[key]


def _leaves(params):
    return [x.numpy() for x in tree_leaves(params)]


# ---------------------------------------------------------------------------
# backend equivalence: pinned schedule -> thread == process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2])
def test_process_backend_bitexact_pinned(shards):
    ht, st = _cached("dana-zero", "thread", shards=shards,
                     pin_schedule=True)
    hp, sp = _cached("dana-zero", "process", shards=shards,
                     pin_schedule=True)
    # schedule telemetry is identical by construction (round-robin pin)
    assert hp.worker == ht.worker
    assert hp.lag == ht.lag
    assert hp.step == ht.step
    np.testing.assert_allclose(hp.gap, ht.gap, rtol=1e-6)
    # elementwise family, same per-row message order: bit-exact params
    for a, b in zip(_leaves(ht.final_params), _leaves(hp.final_params)):
        np.testing.assert_array_equal(a, b)
    assert hp.eval_step == ht.eval_step
    np.testing.assert_allclose(hp.eval_loss, ht.eval_loss, rtol=1e-6)
    assert sp["backend"] == "process"
    assert sp["applied"] == st["applied"] == 24
    assert sp["shard_applied"] == [24] * shards
    assert sp["telemetry_dropped"] == 0
    assert {"shards_ready", "workers_started"} <= set(sp["spawn_s"])


@pytest.mark.parametrize("shards", [1, 2])
def test_process_backend_tracks_jax_process_backend(shards):
    """The port's pinned process run against the JAX package's, from the
    same numpy params0 and the same numpy batch streams."""
    import jax
    import jax.numpy as jnp

    from repro.cluster import ClusterConfig as JClusterConfig
    from repro.cluster import run_cluster as jrun_cluster
    from repro.core.algorithms import make_algorithm as jmake
    from repro.core.gamma import GammaModel as JGammaModel
    from repro.core.types import HyperParams as JHP
    from repro.data.synthetic import ClassificationTask as JTask
    from repro.models.toy import ClassifierGradFn as JClassifierGradFn
    from repro.models.toy import make_classifier_fns as jfns

    jtask = JTask(dim=8, num_classes=4, batch_size=8, seed=3)
    jcfg = JClusterConfig(num_workers=2, total_grads=24, eval_every=8,
                          mode="free", exec_model=JGammaModel(seed=5),
                          backend="process", shards=shards,
                          rpc_timeout=60.0, pin_schedule=True)
    h_j = jrun_cluster(jmake("dana-zero", JHP(**HP)),
                       JClassifierGradFn(DIMS),
                       jax.tree.map(jnp.asarray, _params0()), jtask.batch,
                       jcfg, jfns(DIMS)[2](jtask.eval_batch(32)))
    h_t, _ = _cached("dana-zero", "process", shards=shards,
                     pin_schedule=True)
    for key in ("worker", "lag", "step", "eval_step"):
        assert getattr(h_t, key) == getattr(h_j, key), key
    for key in ("gap", "grad_norm", "eval_loss"):
        np.testing.assert_allclose(getattr(h_t, key), getattr(h_j, key),
                                   **TOL, err_msg=key)
    jl = jax.tree.leaves(h_j.final_params)
    tl = _leaves(h_t.final_params)
    assert [a.shape for a in tl] == [a.shape for a in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_process_backend_ga_asgd_allclose():
    # gap-aware member: the penalty consumes a norm over every row, so
    # reduction order shows in the tail: allclose (shards=1 only; the
    # cross-shard norm exchange is threads-only)
    ht, _ = _run("ga-asgd", "thread", pin_schedule=True)
    hp, sp = _run("ga-asgd", "process", pin_schedule=True)
    assert hp.worker == ht.worker
    assert hp.staleness == [float(x) for x in hp.lag]
    for a, b in zip(_leaves(ht.final_params), _leaves(hp.final_params)):
        np.testing.assert_allclose(a, b, **TOL)
    assert sp["shard_applied"] == [24]


def test_process_backend_free_run_completes():
    # unpinned free mode: no schedule guarantee, but conservation holds
    hist, stats = _run("dana-zero", "process", shards=2, coalesce=4)
    assert stats["applied"] == 24
    assert sum(stats["grads_per_worker"].values()) == 24
    assert len(hist.step) == 24
    assert hist.final_params is not None
    assert stats["mean_coalesce"] >= 1.0
    assert sum(k * c for k, c in stats["coalesce_counts"].items()) == 48
    assert stats["ring_bytes"] == 3 * 4 * FlatSpec.from_tree(
        tree_map(torch.from_numpy, _params0())).rows * 128 * 4


def test_process_backend_pipeline_depth_settles_every_push():
    # pull-ahead: each worker keeps one push in flight; the ring must
    # hold (depth + 1) x workers slots
    hist, stats = _run("dana-zero", "process", shards=2,
                       pipeline_depth=1, mailbox_capacity=4)
    assert stats["applied"] == 24
    assert sum(stats["grads_per_worker"].values()) == 24
    assert len(hist.step) == 24


# ---------------------------------------------------------------------------
# fault surfacing: a killed worker process must name itself, never hang
# ---------------------------------------------------------------------------
class _KillerBatch:
    """Picklable batch source that hard-kills worker 1's process on its
    third draw: a crashed (or OOM-killed) worker child."""

    def __init__(self, task):
        self.task = task

    def __call__(self, wid, counter):
        if wid == 1 and counter >= 2:
            os._exit(1)
        return self.task.batch(wid, counter)


def test_worker_process_death_surfaces_and_does_not_hang():
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    cfg = _cfg("process", grads=100000, workers=2, rpc_timeout=5.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker-1"):
        run_cluster(algo, GRAD_FN, _params0(), _KillerBatch(TASK), cfg)
    assert time.monotonic() - t0 < 60.0


# ---------------------------------------------------------------------------
# support matrix: clean errors, no processes spawned
# ---------------------------------------------------------------------------
def test_process_backend_rejects_deterministic_mode():
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    cfg = dataclasses.replace(_cfg("process"), mode="deterministic")
    with pytest.raises(ValueError, match="live modes"):
        run_cluster(algo, GRAD_FN, _params0(), TASK.batch, cfg)


def test_process_backend_rejects_closure_grad_fn():
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    with pytest.raises(ValueError, match="picklable grad_fn"):
        run_cluster(algo, lambda p, b: p, _params0(), TASK.batch,
                    _cfg("process"))


def test_process_backend_rejects_gap_aware_sharded():
    algo = make_algorithm("ga-asgd", HyperParams(**HP))
    with pytest.raises(ValueError, match="shards=1"):
        run_cluster(algo, GRAD_FN, _params0(), TASK.batch,
                    _cfg("process", shards=2))


def test_process_backend_rejects_hot_rows():
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    rows = FlatSpec.from_tree(tree_map(torch.from_numpy, _params0())).rows
    cfg = _cfg("process", hot_rows=((0, rows), None))
    with pytest.raises(ValueError, match="hot_rows"):
        run_cluster(algo, GRAD_FN, _params0(), TASK.batch, cfg)


@pytest.mark.parametrize("name,kw,match", [
    ("dana-zero", dict(use_kernel=False), "use_kernel must not be False"),
    ("easgd", {}, "kernel-eligible algorithm, got 'easgd'"),
    ("dana-zero", dict(faults=FaultPlan(seed=1, dropout=((1, 4, 8),))),
     "dropout/rejoin"),
    ("dana-zero", dict(shards=2, rebalance=True, record_telemetry=False),
     "row rebalancing"),
    ("dana-zero", dict(shards=2, shard_ranges=((0, 1), (1, 16))),
     "custom shard_ranges"),
    ("dana-zero", dict(pipeline_depth=2, mailbox_capacity=4),
     "raise mailbox_capacity to at least 6"),
])
def test_process_backend_support_matrix_refusals(name, kw, match,
                                                 monkeypatch):
    """The rest of the JAX package's support matrix, with its messages,
    raised before any child process starts."""
    import torch.multiprocessing as tmp

    def no_spawn(*a, **k):
        raise AssertionError("a child was started")

    monkeypatch.setattr(tmp, "get_context", no_spawn)
    algo = make_algorithm(name, HyperParams(**HP))
    with pytest.raises(ValueError, match=match):
        run_cluster(algo, GRAD_FN, _params0(), TASK.batch,
                    _cfg("process", **kw))


# ---------------------------------------------------------------------------
# the ring: a tensor handed to a child through a slot comes back unchanged
# ---------------------------------------------------------------------------
def _echo_shard(shm_name, layout, payload, n):
    """Child: serve ``n`` messages of one shard ring, each reply the
    request's own gradient slot (the child reads the slot through the
    shared tensor it was handed)."""
    shm = _attach(shm_name)
    try:
        ctl = layout.ctl_i(shm.buf)
        box = ShmMailbox(layout, shm.buf, 0, payload)
        stop = _ShmStop(ctl)
        served = 0
        while served < n and not stop.is_set():
            for m in box.drain(4, stop):
                m.respond(Reply(view=m.grad.clone(), step=m.idx + 1))
                served += 1
    finally:
        try:
            shm.close()
        except BufferError:
            pass


def test_ring_slot_round_trips_a_tensor_through_a_child():
    from multiprocessing import shared_memory

    import torch.multiprocessing as tmp

    rows, n = 16, 6
    layout = ShmLayout([(0, rows)], 1, 4, telemetry=False)
    payloads = [{k: t.share_memory_() for k, t in p.items()}
                for p in alloc_rings(layout, "cpu")]
    shm = shared_memory.SharedMemory(create=True, size=layout.total)
    try:
        layout.ctl_i(shm.buf)[:] = 0
        ctx = tmp.get_context("spawn")
        child = ctx.Process(target=_echo_shard,
                            args=(shm.name, layout, payloads[0], n),
                            daemon=True)
        child.start()
        fan = ShmFanout(layout, shm.buf, threading.Lock(), payloads,
                        torch.device("cpu"))
        stop = _ShmStop(layout.ctl_i(shm.buf))
        rng = np.random.default_rng(7)
        out = torch.empty((rows, 128))
        for j in range(n):
            g = torch.from_numpy(rng.standard_normal(
                (rows, 128)).astype(np.float32))
            tok = fan.rpc_post(0, lambda slots, g=g: slots[0].copy_(g),
                               None, 0, 0.0, stop, (out,),
                               rpc_timeout=30.0)
            assert fan.rpc_await(tok, 0, stop, 30.0, (out,)) == j + 1
            assert torch.equal(out, g)
        child.join(timeout=30)
        assert child.exitcode == 0
    finally:
        shm.close()
        shm.unlink()


# ---------------------------------------------------------------------------
# regression: master shutdown hang (unbounded join)
# ---------------------------------------------------------------------------
def test_stuck_master_serve_loop_surfaces_instead_of_hanging(monkeypatch):
    from repro_torch.cluster import master as master_mod

    def stuck_serve(self):
        # a wedged serve loop: signals stop (so workers drain out and an
        # unbounded join would wait forever) but never returns
        self.stop.set()
        time.sleep(30.0)

    monkeypatch.setattr(master_mod.Master, "serve", stuck_serve)
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    cfg = _cfg("thread", grads=20, rpc_timeout=0.5)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="master failed to shut down"):
        run_cluster(algo, GRAD_FN, _params0(), TASK.batch, cfg)
    # bounded: the deadline is max(rpc_timeout, 2s), not the 30s nap
    assert time.monotonic() - t0 < 15.0


# ---------------------------------------------------------------------------
# regression: fan-out telemetry must flush or be counted, never vanish
# ---------------------------------------------------------------------------
def _group(shards, tele, drops):
    msg = GradMsg(0, grad=object(), view=None, view_step=0, t_send=1.0)
    return msg, _ReplyGroup(
        msg, shards,
        tele_cb=lambda **kw: tele.append(kw),
        drop_cb=lambda: drops.append(1))


def test_reply_group_flushes_when_shard0_meta_lands_last():
    tele, drops = [], []
    msg, g = _group(2, tele, drops)
    g.add_telemetry(1, worker=0, step=3, lag=1, t=0.0, d2=1.0, g2=2.0)
    g.shard_reply(1, Reply(view="v1", step=3))
    # shard 0 applies (and carries the canonical meta) last
    g.add_telemetry(0, worker=0, step=3, lag=1, t=1.5, d2=0.5, g2=0.25)
    g.shard_reply(0, Reply(view="v0", step=3))
    assert drops == []
    assert len(tele) == 1
    assert tele[0]["d2"] == pytest.approx(1.5)
    assert tele[0]["g2"] == pytest.approx(2.25)
    assert tele[0]["t"] == pytest.approx(1.5)


def test_reply_group_counts_drop_on_failed_shard():
    tele, drops = [], []
    msg, g = _group(2, tele, drops)
    g.add_telemetry(0, worker=0, step=3, lag=1, t=1.5, d2=0.5, g2=0.25)
    g.shard_reply(0, Reply(view="v0", step=3))
    g.shard_reply(1, None)        # shard 1 rejected: the group fails
    assert msg.wait_reply(1.0) is None
    assert tele == []             # partial sums must not flush...
    assert drops == [1]           # ...but the loss is counted


def test_reply_group_pull_only_is_not_a_drop():
    tele, drops = [], []
    msg, g = _group(2, tele, drops)
    g.shard_reply(0, Reply(view="v0", step=3))
    g.shard_reply(1, Reply(view="v1", step=3))
    assert msg.wait_reply(1.0) is not None
    assert tele == [] and drops == []


def test_sharded_run_reports_zero_drops_when_healthy():
    stats = {}
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    run_cluster(algo, GRAD_FN, _params0(), TASK.batch,
                _cfg("thread", shards=2), stats_out=stats)
    assert stats["telemetry_dropped"] == 0


# ---------------------------------------------------------------------------
# regression: the hot_rows upper bound is INCLUSIVE (r1 == rows_total is
# the full-height range) and the error message says so
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2])
def test_hot_rows_full_height_range_is_valid(shards):
    rows = FlatSpec.from_tree(tree_map(torch.from_numpy, _params0())).rows
    stats = {}
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    run_cluster(algo, GRAD_FN, _params0(), TASK.batch,
                _cfg("thread", shards=shards, grads=12,
                     hot_rows=((0, rows), None)),
                stats_out=stats)
    assert stats["applied"] == 12


@pytest.mark.parametrize("shards", [1, 2])
def test_hot_rows_past_end_rejected_with_inclusive_message(shards):
    rows = FlatSpec.from_tree(tree_map(torch.from_numpy, _params0())).rows
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    with pytest.raises(ValueError,
                       match=r"0 <= r0 < r1 <= \d+ \(r1 bound inclusive\)"):
        run_cluster(algo, GRAD_FN, _params0(), TASK.batch,
                    _cfg("thread", shards=shards, grads=12,
                         hot_rows=((0, rows + 1), None)))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [
    ["--dim", "8", "--width", "16", "--batch", "8", "--shards", "2"],
    ["--preset", "lm", "--batch", "2"]], ids=["classifier", "lm"])
def test_cluster_cli_process_backend(extra):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--device",
         "cpu", "--backend", "process", "--mode", "free", "--workers", "2",
         "--grads", "12", "--eval-every", "6"] + extra,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "backend: process" in proc.stdout
    assert "applied: 12" in proc.stdout
    loss = [ln for ln in proc.stdout.splitlines()
            if ln.strip().startswith("final_loss:")]
    assert loss and np.isfinite(float(loss[0].split(":")[1]))


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_pack_into_row_ranges_is_pack_split(shards):
    """A worker packs its gradient straight into the ring slots:
    ``FlatSpec.pack_into`` split by row range is ``pack`` bit for bit,
    and both are the raveled leaves in treedef order followed by zero
    padding, leaves straddling ranges included, whatever the slots
    held before."""
    dims = [40, 24, 5]
    p = make_classifier_fns(dims)[0](np.random.default_rng(3), device="cpu")
    spec = FlatSpec.from_tree(p)
    leaves = flatten_up_to(spec.treedef, p)
    want = torch.cat([l.reshape(-1).float() for l in leaves]
                     + [torch.zeros(spec.padded - spec.n_elems)])
    ranges = spec.row_ranges(shards)
    outs = [torch.full((r1 - r0, 128), float("nan")) for r0, r1 in ranges]
    spec.pack_into(p, outs, ranges)
    assert torch.equal(torch.cat(outs).reshape(-1), want)
    assert torch.equal(spec.pack(p).reshape(-1), want)
