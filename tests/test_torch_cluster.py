"""The port's threaded cluster against its own engine and the JAX cluster.

* Deterministic mode replays the engine's event order through a virtual
  clock, so the port's cluster equals the port's ``run_simulation`` BIT
  FOR BIT — event stream, telemetry, eval curve and final parameters —
  for every ported algorithm, on the tree path and on the flat path.
* Against the JAX package's deterministic cluster on the same numpy
  ``params0`` and the same numpy batch and gamma streams: the event
  stream (time, worker, lag, step) is EQUAL; gaps, norms, eval losses
  and final parameters agree to rtol=1e-5, atol=1e-6 (the tolerance of
  ``test_torch_engine.py``: the JAX package jits its steps, XLA
  contracts FMAs and sums its matrix products in another order).  The
  runs start from ``params0`` seed 1 (ROADMAP.md section C).
* The coalesced flat pass equals k sequential rounds, and the three
  master paths (tree, legacy ``dana_update`` with ``flat=False``, flat)
  agree bit for bit — the checks the JAX package's
  ``test_cluster.py`` makes and its jitted paths fail by an FMA.
* Live modes are thread-scheduling dependent: those tests assert
  totals and invariants, never per-worker counts.

Every run is small (4-8 workers, at most 120 gradients) and bounded in
time: ``rpc_timeout`` bounds every reply wait and thread join.
"""
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import FaultInjector as JFaultInjector
from repro.cluster import FaultPlan as JFaultPlan
from repro.cluster import run_cluster as jrun_cluster
from repro.core.algorithms import make_algorithm as jmake
from repro.core.gamma import GammaModel as JGammaModel
from repro.core.types import HyperParams as JHP
from repro.data.synthetic import ClassificationTask as JTask
from repro.models.toy import make_classifier_fns as jfns

from repro_torch.cluster import (ClusterConfig, FaultInjector, FaultPlan,
                                 GradMsg, Mailbox, Master, run_cluster)
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.engine import SimulationConfig, run_simulation
from repro_torch.core.gamma import GammaModel
from repro_torch.core.metrics import History
from repro_torch.core.types import HyperParams, tree_leaves, tree_map
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.kernels import launches, reset_launches
from repro_torch.models.toy import ClassifierGradFn, make_classifier_fns
from repro_torch.obs import MetricsRegistry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DIMS = [8, 16, 4]
HP = dict(lr=0.05, momentum=0.9)
TOL = dict(rtol=1e-5, atol=1e-6)
ALGOS = ["asgd", "nag-asgd", "multi-asgd", "dana-zero", "dana-slim"]
RPC = 20.0                      # seconds: bounds every reply wait / join
TASK = ClassificationTask(dim=8, num_classes=4, batch_size=8, seed=3,
                          device="cpu")
_, GRAD_FN, MAKE_EVAL = make_classifier_fns(DIMS)
EVAL_FN = MAKE_EVAL(TASK.eval_batch(32))


def _params0(seed=1):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(DIMS[:-1], DIMS[1:])]


def _cfg(**kw):
    base = dict(num_workers=4, total_grads=60, eval_every=20,
                exec_model=GammaModel(seed=5), rpc_timeout=RPC,
                device="cpu")
    base.update(kw)
    return ClusterConfig(**base)


def _cluster(name, *, seed=1, stats=None, metrics=None, **kw):
    return run_cluster(make_algorithm(name, HyperParams(**HP)), GRAD_FN,
                       _params0(seed), TASK.batch, _cfg(**kw), EVAL_FN,
                       stats_out=stats, metrics=metrics)


def _engine(name, *, use_kernel, grads=60, seed=1):
    return run_simulation(
        make_algorithm(name, HyperParams(**HP)), GRAD_FN, _params0(seed),
        TASK.batch,
        SimulationConfig(num_workers=4, total_grads=grads, eval_every=20,
                         exec_model=GammaModel(seed=5),
                         use_kernel=use_kernel, device="cpu"), EVAL_FN)


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _assert_same_run(h_c, h_e):
    for key in ("time", "worker", "lag", "step", "gap", "grad_norm",
                "eval_time", "eval_step", "eval_loss", "eval_metric"):
        assert getattr(h_c, key) == getattr(h_e, key), key
    # the sent-snapshot staleness column (NaN for snapshot-free members)
    np.testing.assert_array_equal(h_c.staleness, h_e.staleness)
    _trees_equal(h_c.final_params, h_e.final_params)


# members with state beyond the momentum family's: the gap-aware
# kernel's, the sent snapshot with delay compensation, the staleness
# lane, and the rate lane fed by message timestamps
NEW_MEMBERS = ["ga-asgd", "dana-dc", "sa-asgd", "dana-hetero"]


# ---------------------------------------------------------------------------
# (a) deterministic mode == the port's engine, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
@pytest.mark.parametrize("name", ALGOS + NEW_MEMBERS)
def test_deterministic_cluster_equals_engine(name, flat):
    stats = {}
    h_c = _cluster(name, use_kernel=flat, stats=stats)
    h_e = _engine(name, use_kernel=flat)
    assert stats["flat"] is flat and stats["coalesce_counts"] == {1: 60}
    assert len(h_c.gap) == 60 and len(h_c.eval_loss) == 3
    _assert_same_run(h_c, h_e)


def test_legacy_kernel_path_equals_tree_path():
    """use_kernel=True, flat=False: the per-message dana_update round
    (its plain version here) ends where the tree path ends."""
    h_l = _cluster("dana-zero", use_kernel=True, flat=False)
    h_t = _cluster("dana-zero", use_kernel=False)
    _assert_same_run(h_l, h_t)


# ---------------------------------------------------------------------------
# (b) deterministic mode against the JAX deterministic cluster
# ---------------------------------------------------------------------------
def _jax_cluster(name, p0, use_kernel):
    jtask = JTask(dim=8, num_classes=4, batch_size=8, seed=3)
    _, jgrad, jmk = jfns(DIMS)
    cfg = JClusterConfig(num_workers=4, total_grads=60, eval_every=20,
                         exec_model=JGammaModel(seed=5),
                         use_kernel=use_kernel, rpc_timeout=RPC)
    return jrun_cluster(jmake(name, JHP(**HP)), jgrad,
                        jax.tree.map(jnp.asarray, p0), jtask.batch, cfg,
                        jmk(jtask.eval_batch(32)))


@pytest.mark.parametrize("name,flat", [(n, False) for n in ALGOS]
                         + [("dana-zero", True)])
def test_deterministic_cluster_tracks_jax_cluster(name, flat):
    h_j = _jax_cluster(name, _params0(1), flat)
    h_t = _cluster(name, use_kernel=flat)
    for key in ("time", "worker", "lag", "step", "eval_step"):
        assert getattr(h_t, key) == getattr(h_j, key), key
    for key in ("gap", "grad_norm", "eval_loss", "eval_metric"):
        np.testing.assert_allclose(getattr(h_t, key), getattr(h_j, key),
                                   **TOL, err_msg=key)
    jl = jax.tree.leaves(h_j.final_params)
    tl = tree_leaves(h_t.final_params)
    assert [tuple(a.shape) for a in tl] == [a.shape for a in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# (c) coalesced receive and the three master paths
# ---------------------------------------------------------------------------
def _master(n, *, use_kernel=False, flat=None, telemetry=False):
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    state = algo.init(tree_map(torch.from_numpy, _params0(1)), n)
    return Master(algo, state, mailbox=Mailbox(), history=History(),
                  stop=threading.Event(), total_grads=100, coalesce=8,
                  use_kernel=use_kernel, flat=flat,
                  record_telemetry=telemetry)


def _grads(k, seed=0):
    p = tree_map(torch.from_numpy, _params0(1))
    return [GRAD_FN(p, TASK.batch(j % 3, seed + j)) for j in range(k)]


def _apply(master, ids, grads, views=None):
    """Run ids/grads through ``master._apply`` as one batch; returns the
    reply views."""
    msgs = [GradMsg(i, g, None if views is None else views[j], 0, 0.0)
            for j, (i, g) in enumerate(zip(ids, grads))]
    master._apply(msgs)
    return [m.wait_reply(RPC).view for m in msgs]


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_coalesced_pass_equals_sequential_receive(flat):
    ids = [0, 2, 1, 2]
    m_co = _master(4, use_kernel=flat)
    m_seq = _master(4, use_kernel=flat)
    grads = _grads(4)
    if flat:
        spec = m_co._flat_algo.spec
        grads = [spec.pack(g) for g in grads]
    v_co = _apply(m_co, ids, grads)
    v_seq = [_apply(m_seq, [i], [g])[0] for i, g in zip(ids, grads)]
    assert m_co.step == m_seq.step == 4
    for a, b in zip(v_co, v_seq):
        if flat:
            assert torch.equal(a, b)
        else:
            _trees_equal(a, b)
    for key in ("theta0", "v", "v0"):
        _trees_equal(m_co.state[key], m_seq.state[key])
    if flat:
        # each reply view owns its storage: a view a worker keeps does
        # not pin the rest of its batch
        assert all(v.untyped_storage().nbytes() == v.numel() * 4
                   for v in v_co)


def test_three_master_paths_agree():
    ids = [1, 3, 1, 0]
    m_plain = _master(4)
    m_legacy = _master(4, use_kernel=True, flat=False)
    m_flat = _master(4, use_kernel=True)
    assert m_legacy.legacy_kernel and not m_legacy.state_is_flat
    assert m_flat.state_is_flat and not m_flat.legacy_kernel
    grads = _grads(4, seed=7)
    spec = m_flat._flat_algo.spec
    reset_launches()
    v_p = _apply(m_plain, ids, grads)
    v_k = _apply(m_legacy, ids, grads)
    v_f = [spec.unpack(v) for v in
           _apply(m_flat, ids, [spec.pack(g) for g in grads])]
    assert set(launches().values()) == {0}      # CPU: plain versions
    for other in (m_legacy, m_flat):
        for key in ("theta0", "v", "v0"):
            _trees_equal(m_plain.state[key], other.state[key])
    for v_other in (v_k, v_f):
        for a, b in zip(v_p, v_other):
            _trees_equal(a, b)


def test_flat_telemetry_equals_tree_telemetry():
    """Telemetry on the flat path reduces leaf by leaf like the tree
    path (and the engine): the spooled rows are bit-equal."""
    ids = [2, 0, 2]
    grads = _grads(3, seed=11)
    m_t = _master(3, telemetry=True)
    m_f = _master(3, use_kernel=True, telemetry=True)
    spec = m_f._flat_algo.spec
    views_t = [m_t.initial_view(i)[0] for i in ids]
    views_f = [m_f.initial_view(i)[0] for i in ids]
    _apply(m_t, ids, grads, views_t)
    _apply(m_f, ids, [spec.pack(g) for g in grads], views_f)
    m_t._flush_telemetry()
    m_f._flush_telemetry()
    assert len(m_t.history.gap) == 3
    for key in ("step", "worker", "lag", "gap", "grad_norm"):
        assert getattr(m_t.history, key) == getattr(m_f.history, key), key


# ---------------------------------------------------------------------------
# (d) live modes and faults: totals and invariants
# ---------------------------------------------------------------------------
def test_free_mode_coalescing_completes():
    stats = {}
    hist = _cluster("dana-zero", mode="free", num_workers=8,
                    total_grads=120, coalesce=4, record_telemetry=False,
                    stats=stats)
    assert stats["applied"] == 120
    assert sum(stats["grads_per_worker"].values()) == 120
    assert sum(k * c for k, c in stats["coalesce_counts"].items()) == 120
    assert max(stats["coalesce_counts"]) <= 4
    assert stats["use_kernel"] is True and stats["flat"] is True
    assert all(np.isfinite(hist.eval_loss))
    assert hist.final_params is not None


@pytest.mark.parametrize("mode,depth", [("free", 0), ("paced", 1)])
def test_telemetry_recorded_in_live_mode(mode, depth):
    reg = MetricsRegistry()
    stats = {}
    hist = _cluster("multi-asgd", mode=mode, total_grads=120, coalesce=2,
                    eval_every=40, time_scale=1e-5, pipeline_depth=depth,
                    stats=stats, metrics=reg)
    assert len(hist.time) == len(hist.gap) == len(hist.lag) == 120
    assert all(l >= 0 for l in hist.lag)
    assert hist.eval_loss and all(np.isfinite(hist.eval_loss))
    assert sorted(hist.step) == list(range(1, 121))
    snap = reg.snapshot()
    assert snap["updates"]["value"] == 120
    assert snap["drain_k"]["count"] == sum(stats["coalesce_counts"]
                                           .values())
    assert "mailbox_depth" in stats["obs_series"]


@pytest.mark.parametrize("name,mode,depth", [("ga-asgd", "free", 0),
                                             ("dc-asgd", "paced", 1)])
def test_live_snapshot_staleness_is_the_lag(name, mode, depth):
    """The flat path reads the snapshot staleness from the host lane
    (coalesced batches, duplicate ids chaining); with pull-ahead the
    lane undercounts by the depth and the master records the lag."""
    stats = {}
    hist = _cluster(name, mode=mode, total_grads=80, coalesce=4,
                    eval_every=40, time_scale=1e-5, pipeline_depth=depth,
                    stats=stats)
    assert stats["flat"] is True and len(hist.staleness) == 80
    assert hist.staleness == [float(l) for l in hist.lag]
    assert max(hist.lag) > 0 and all(np.isfinite(hist.eval_loss))


def test_dropout_worker_rejoins():
    reg = MetricsRegistry()
    stats = {}
    _cluster("dana-slim", mode="free", total_grads=120, coalesce=2,
             faults=FaultPlan(seed=1, dropout=((2, 20, 80),)),
             record_telemetry=False, stats=stats, metrics=reg)
    assert stats["applied"] == 120
    assert sum(stats["grads_per_worker"].values()) == 120
    assert reg.snapshot()["pulls"]["value"] >= 1       # the rejoin pull


def test_stalls_deterministic_and_reproducible():
    """In deterministic mode injected stalls inflate *virtual* time, so
    the faulty run is still exactly reproducible."""
    plan = FaultPlan(seed=3, stall_prob=0.25, stall_scale=4.0)
    h1 = _cluster("dana-zero", faults=plan)
    h2 = _cluster("dana-zero", faults=plan)
    assert h1.time == h2.time and h1.gap == h2.gap
    _trees_equal(h1.final_params, h2.final_params)
    assert _cluster("dana-zero").time != h1.time


def test_reordering_preserves_totals():
    hist = _cluster("asgd", mode="free", num_workers=6, total_grads=120,
                    coalesce=4, faults=FaultPlan(seed=2, reorder_prob=1.0))
    assert len(hist.step) == 120
    assert all(l >= 0 for l in hist.lag)


def test_dropout_rejected_in_deterministic_mode():
    with pytest.raises(ValueError, match="dropout"):
        _cluster("asgd", num_workers=2, total_grads=10,
                 faults=FaultPlan(dropout=((0, 1, 2),)))


def test_bounded_mailbox_applies_backpressure():
    stats = {}
    _cluster("asgd", mode="free", num_workers=6, total_grads=120,
             coalesce=4, mailbox_capacity=2, record_telemetry=False,
             stats=stats)
    assert stats["applied"] == 120
    # a capacity-2 queue can never serve a coalesce window above 2
    assert max(stats["coalesce_counts"]) <= 2


def test_fault_streams_equal_the_jax_package():
    plan = dict(seed=4, stall_prob=0.3, stall_scale=3.0, reorder_prob=0.5)
    port = FaultInjector(FaultPlan(**plan), 3, 128)
    ref = JFaultInjector(JFaultPlan(**plan), 3, 128)
    for j in range(50):
        assert port.stall(j % 3) == ref.stall(j % 3)
        msgs = list(range(2 + j % 5))
        assert port.reorder(msgs) == ref.reorder(msgs)
    windows = ((1, 5, 9),)
    port = FaultInjector(FaultPlan(dropout=windows), 3, 128)
    ref = JFaultInjector(JFaultPlan(dropout=windows), 3, 128)
    for step in range(12):
        assert port.offline_until(1, step) == ref.offline_until(1, step)


def test_classifier_grad_fn_pickles():
    fn = pickle.loads(pickle.dumps(ClassifierGradFn(DIMS)))
    p = tree_map(torch.from_numpy, _params0(2))
    batch = TASK.batch(0, 0)
    _trees_equal(fn(p, batch), GRAD_FN(p, batch))


# ---------------------------------------------------------------------------
# (e) what the port does not implement yet raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,item", [
    (dict(shards=2), "A4"), (dict(rebalance=True), "A4"),
    (dict(shard_ranges=((0, 1),)), "A4"), (dict(backend="process"), "A5"),
    (dict(hot_rows=(None,) * 4), "A3")])
def test_unported_options_raise(kw, item):
    """Every option of the JAX package's ``ClusterConfig`` is ported: the
    process backend (A5) runs (its workers need a picklable grad_fn),
    the row-sharded master (A4) and hot-row pulls (A3) run, with the JAX
    package's guards: rebalancing and shard ranges need shards > 1."""
    if item == "A5":
        stats = {}
        run_cluster(make_algorithm("dana-zero", HyperParams(**HP)),
                    ClassifierGradFn(DIMS), _params0(1), TASK.batch,
                    _cfg(mode="free", **kw), EVAL_FN, stats_out=stats)
        assert stats["applied"] == 60
        assert stats["backend"] == "process"
        return
    if "shards" in kw or "hot_rows" in kw:
        stats = {}
        _cluster("dana-zero", mode="free", stats=stats, **kw)
        assert stats["applied"] == 60
        assert stats.get("shard_applied", [60]) == [60] * kw.get("shards",
                                                                  1)
        return
    with pytest.raises(ValueError, match="shards > 1"):
        _cluster("dana-zero", mode="free", **kw)


def test_legacy_kernel_path_takes_only_dana_zero():
    with pytest.raises(ValueError, match="DANA-Zero"):
        _cluster("asgd", use_kernel=True, flat=False)


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------
def test_cluster_cli_compare_engine_is_bit_exact(tmp_path):
    out = tmp_path / "cluster.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--device",
         "cpu", "--mode", "deterministic", "--compare-engine",
         "--workers", "3", "--grads", "30", "--dim", "8", "--width", "16",
         "--batch", "8", "--eval-every", "10", "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "BIT-EXACT" in proc.stdout
    assert out.exists()


def test_cluster_cli_ga_asgd_compare_engine_is_bit_exact():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--device",
         "cpu", "--algo", "ga-asgd", "--mode", "deterministic",
         "--compare-engine", "--workers", "3", "--grads", "30", "--dim",
         "8", "--width", "16", "--batch", "8", "--eval-every", "10"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "BIT-EXACT" in proc.stdout
