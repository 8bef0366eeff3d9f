"""Hot-row pulls and row rebalancing in the port: the counterparts of the
JAX package's ``tests/test_memtier.py`` (hot rows, rebalancing) and
``tests/test_pipeline.py`` (warm-up).

* ``FlatAlgorithm.view_rows`` equals the full view's rows bit for bit for
  every member whose send writes no state, and the eager JAX
  ``view_rows`` on the same state: bit for bit, dana-hetero's weighted
  sum at rtol 1e-6 / atol 1e-7 (ROADMAP.md C10).
* The plain ``flat_send_view`` reads a strided row range of the slab as
  it reads a contiguous copy (the CUDA kernel's pitch is checked on the
  card, ``tests/test_torch_gpu.py``).
* ``Master._pull_reply`` serves hot rows; members whose send writes
  state fall back to the full view; a worker merges a partial reply.
* Threaded runs with ``hot_rows`` complete, with and without dropout,
  single and sharded; the rebalancer moves rows and keeps the maths.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms import make_algorithm as jmake
from repro.core.types import HyperParams as JHP
from repro.kernels.flat_update import FlatAlgorithm as JFlat

from repro_torch.cluster import (ClusterConfig, FaultPlan, GradMsg,
                                 Mailbox, Master, ShardedMaster, Worker,
                                 run_cluster)
from repro_torch.cluster.runtime import _hot_rows
from repro_torch.cluster.sharded import RowRebalancer
from repro_torch.convert import flat_state_from_numpy, params_from_numpy
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.gamma import GammaModel
from repro_torch.core.metrics import History
from repro_torch.core.types import HyperParams, tree_leaves
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.kernels.flat_update import (FlatAlgorithm,
                                             flat_send_view_ref)
from repro_torch.kernels.flat_update.ops import family_spec_for
from repro_torch.models.toy import make_classifier_fns
from repro_torch.obs import MetricsRegistry

torch.set_num_threads(1)

HP = dict(lr=0.05, momentum=0.9)
DIMS = [16, 64, 4]                  # 16 rows, 11 of them real
TASK = ClassificationTask(dim=16, num_classes=4, batch_size=8, seed=3,
                          device="cpu")
_, GRAD_FN, _ = make_classifier_fns(DIMS)
RPC = 20.0
# every flat member whose send writes no state: its pull can be a view
PURE_SEND = sorted(
    n for n in ("asgd", "dana-hetero", "dana-nadam", "dana-slim",
                "dana-zero", "lwp", "multi-asgd", "nadam-asgd", "nag-asgd",
                "sa-asgd", "dc-asgd", "dana-dc", "ga-asgd")
    if not family_spec_for(make_algorithm(n)).stateful_send)
RANGES = ((0, 8), (3, 11), (8, 16), (0, 16))


def _params0_np(seed=1, dims=DIMS):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _states(name):
    """The JAX flat state after two eager batches (nonzero momenta), and
    the port's FlatAlgorithm with the same state converted."""
    p0 = _params0_np()
    jfa = JFlat(jmake(name, JHP(**HP)))
    tfa = FlatAlgorithm(make_algorithm(name, HyperParams(**HP)))
    tfa.adopt(tfa.algo.init(params_from_numpy(p0, "cpu"), 4))
    rng = np.random.default_rng(5)
    with jax.disable_jit():
        js = jfa.init(jax.tree.map(jnp.asarray, p0), 4)
        for ids in ([1, 3, 1], [0, 2, 2]):
            g = jnp.asarray(rng.standard_normal(
                (3, tfa.spec.rows, 128)).astype(np.float32) * 0.1)
            js, _, _ = jfa.apply_batch(
                js, jnp.asarray(ids, jnp.int32), g,
                jnp.asarray([0.5, 1.0, 1.5], jnp.float32))
    ts = flat_state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                               "cpu")
    return jfa, js, tfa, ts


@pytest.mark.parametrize("name", PURE_SEND)
def test_view_rows_is_the_full_views_rows(name):
    jfa, js, tfa, ts = _states(name)
    full = tfa._view_flat(ts, 1)
    for r0, r1 in RANGES:
        part = tfa.view_rows(ts, 1, r0, r1)
        assert part.shape == (r1 - r0, 128)
        assert torch.equal(part, full[r0:r1])
        with jax.disable_jit():
            jpart = np.asarray(jfa.view_rows(js, jnp.int32(1), r0, r1))
        if name == "dana-hetero":
            np.testing.assert_allclose(part.numpy(), jpart, rtol=1e-6,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(part.numpy(), jpart)
    empty = tfa.view_rows(ts, 1, 8, 8)
    assert empty.shape == (0, 128)


@pytest.mark.parametrize("n", [1, 8, 64])
@pytest.mark.parametrize("adaptive", [False, True])
def test_plain_send_view_reads_a_strided_row_range(n, adaptive):
    rng = np.random.default_rng(n)

    def randn(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    theta, slab = randn(40, 128), randn(n, 40, 128)
    w = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    u2 = randn(40, 128).abs() * 0.01 if adaptive else None
    c = np.float32(0.05) * np.float32(0.9)
    for r0, r1 in ((0, 8), (13, 29), (32, 40)):
        strided = slab[:, r0:r1]
        assert n == 1 or not strided.is_contiguous()
        u = None if u2 is None else u2[r0:r1]
        out = flat_send_view_ref(theta[r0:r1], strided, w, c, u2=u)
        ref = flat_send_view_ref(theta[r0:r1].clone(), strided.contiguous(),
                                 w, c, u2=None if u is None else u.clone())
        assert torch.equal(out, ref)


def _master(name, n=3):
    algo = make_algorithm(name, HyperParams(**HP))
    return Master(algo, algo.init(params_from_numpy(_params0_np(), "cpu"),
                                  n), mailbox=Mailbox(), history=History(),
                  stop=threading.Event(), total_grads=10,
                  record_telemetry=False, use_kernel=True)


def test_master_pull_reply_serves_hot_rows():
    m = _master("dana-zero")
    full, _ = m.initial_view(1)
    msg = GradMsg(1, None, None, 0, 0.0, rows=(0, 8))
    assert m._pull_reply(msg) == 8
    reply = msg.wait_reply(1.0)
    assert reply.rows == (0, 8) and torch.equal(reply.view, full[0:8])


@pytest.mark.parametrize("name", ["dc-asgd", "sa-asgd", "ga-asgd"])
def test_master_pull_reply_stateful_send_falls_back(name):
    """A send that writes state (a snapshot row, a staleness stamp)
    cannot be a pure row view: the master serves the full send
    (Reply.rows None: the worker replaces its view)."""
    m = _master(name)
    rows = m._flat_algo.spec.rows
    msg = GradMsg(1, None, None, 0, 0.0, rows=(0, 8))
    assert m._pull_reply(msg) == rows
    reply = msg.wait_reply(1.0)
    assert reply.rows is None and reply.view.shape == (rows, 128)


@pytest.mark.parametrize("sharded", [False, True])
def test_worker_merges_a_partial_reply(sharded):
    """A rejoin pull with hot rows patches exactly those rows of a COPY
    of the cached view; the others keep the cached values."""
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    state = algo.init(params_from_numpy(_params0_np(), "cpu"), 2)
    stop = threading.Event()
    cfg = ClusterConfig(num_workers=2, hot_rows=(None, (3, 11)),
                        device="cpu")
    if sharded:
        m = ShardedMaster(algo, state, shards=2, history=History(),
                          stop=stop, total_grads=10,
                          record_telemetry=False)
        mailbox = m.frontdoor
    else:
        m = Master(algo, state, mailbox=Mailbox(), history=History(),
                   stop=stop, total_grads=10, record_telemetry=False,
                   use_kernel=True)
        mailbox = m.mailbox
    hot, merges = _hot_rows(cfg, m, sharded)
    assert hot == [None, (3, 11)] and merges[0] is None
    full, _ = m.initial_view(1)
    old = (tuple(v + 1.0 for v in full) if sharded else full + 1.0)
    cat = (lambda v: torch.cat(v)) if sharded else (lambda v: v.clone())
    fullc, oldc = cat(full), cat(old)
    w = Worker(1, master=m, mailbox=mailbox, grad_fn=None, next_batch=None,
               stop=stop, mode="free", init_view=(old, 0), rpc_timeout=RPC,
               hot_rows=hot[1], merge_view=merges[1], telemetry=False)
    t = threading.Thread(target=w._push, args=(None, 0.0))
    t.start()
    servers = m.shards_ if sharded else [m]
    for srv in servers:
        msgs = srv.mailbox.drain(1, stop, timeout=RPC)
        assert msgs[0].rows is not None
        srv._pull_reply(msgs[0])
    t.join(timeout=RPC)
    assert not t.is_alive()
    got = cat(w._view)
    assert torch.equal(got[3:11], fullc[3:11])
    assert torch.equal(got[:3], oldc[:3]) and torch.equal(got[11:],
                                                          oldc[11:])
    assert torch.equal(cat(old), oldc)     # the cached view was not written


def test_warm_makes_every_declared_range():
    m = _master("dana-zero")
    m.warm(hot_ranges=((0, 8), (4, 12)))
    assert set(m._view_rows_fns) == {(0, 8), (4, 12)}
    out = m._view_rows_fn(4, 12)(m._flat_state, 1)
    assert out.shape == (8, 128) and len(m._view_rows_fns) == 2
    sent = _master("dc-asgd")
    sent.warm(hot_ranges=((0, 8),))
    assert not sent._view_rows_fns
    algo = make_algorithm("dana-zero", HyperParams(**HP))
    sm = ShardedMaster(algo, algo.init(params_from_numpy(_params0_np(),
                                                          "cpu"), 3),
                       shards=2, history=History(), stop=threading.Event(),
                       total_grads=10, record_telemetry=False)
    sm.warm(hot_ranges=((3, 11),))
    # the fan-out's shard-local slices of (3, 11) over (0, 8), (8, 16)
    assert set(sm.shards_[0]._view_rows_fns) == {(3, 8)}
    assert set(sm.shards_[1]._view_rows_fns) == {(0, 3)}


def _cfg(**kw):
    base = dict(num_workers=4, total_grads=60, eval_every=20,
                exec_model=GammaModel(seed=5), rpc_timeout=RPC,
                device="cpu")
    base.update(kw)
    return ClusterConfig(**base)


def _run(cfg, name="dana-zero", stats=None, metrics=None, params0=None,
         grad_fn=GRAD_FN, batch=TASK.batch):
    return run_cluster(make_algorithm(name, HyperParams(**HP)), grad_fn,
                       params0 if params0 is not None else _params0_np(),
                       batch, cfg, stats_out=stats, metrics=metrics)


@pytest.mark.parametrize("shards", [1, 2])
def test_cluster_hot_row_pulls_with_dropout(shards):
    """Free mode: worker 1 drops out at its second iteration (the window
    opens at step 1 and closes at step 100, so a loaded machine cannot
    skip it) and rejoins through a pull carrying its hot range; every
    gradient is applied and the pull is counted."""
    reg, stats = MetricsRegistry(), {}
    _run(_cfg(total_grads=160, eval_every=10_000, mode="free", coalesce=2,
              shards=shards, faults=FaultPlan(dropout=((1, 1, 100),)),
              hot_rows=(None, (0, 8), (0, 8), None)),
         stats=stats, metrics=reg)
    assert stats["applied"] == 160
    snap = reg.snapshot()
    assert 0 < snap["slab_rows_streamed"]["value"] \
        <= snap["slab_rows_total"]["value"]
    assert snap["pulls"]["value"] >= 1


@pytest.mark.parametrize("shards", [1, 2])
def test_hot_rows_leave_a_run_without_pulls_unchanged(shards):
    """Deterministic runs (no dropout, so no pulls): declaring hot rows
    changes nothing, bit for bit."""
    kw = dict(shards=shards, use_kernel=True, record_telemetry=False)
    a = _run(_cfg(**kw))
    b = _run(_cfg(hot_rows=((0, 8), None, (3, 11), (8, 16)), **kw))
    for x, y in zip(tree_leaves(a.final_params),
                    tree_leaves(b.final_params)):
        assert torch.equal(x, y)


def test_rebalance_moves_rows_and_preserves_math(monkeypatch):
    """Two shards skewed 1040 / 8 rows: the rebalancer (its busy signal
    pinned to the rows each shard holds, as the JAX test pins it) moves
    rows off shard 0, and the final parameters equal the same run
    without rebalancing bit for bit."""
    monkeypatch.setattr(
        RowRebalancer, "_busy",
        lambda self: [float(s.r1 - s.r0) for s in self.owner.shards_])
    dims = [256, 512, 4]
    task = ClassificationTask(dim=256, num_classes=4, batch_size=8, seed=3,
                              device="cpu")
    _, grad_fn, _ = make_classifier_fns(dims)

    def run(rebalance):
        stats = {}
        hist = _run(_cfg(total_grads=40, eval_every=10, shards=2,
                         record_telemetry=False,
                         shard_ranges=((0, 1040), (1040, 1048)),
                         rebalance=rebalance, rebalance_threshold=1.05),
                    params0=_params0_np(1, dims), grad_fn=grad_fn,
                    batch=task.batch, stats=stats)
        return hist.final_params, stats

    p_no, _ = run(False)
    p_rb, s_rb = run(True)
    moves = s_rb["rebalance_moves"]
    assert moves
    for wm, donor, recv, n_rows in moves:
        assert donor == 0 and recv == 1 and n_rows % 8 == 0 and n_rows > 0
    r0, r1 = s_rb["shard_ranges"][0]
    assert r1 - r0 < 1040
    for a, b in zip(tree_leaves(p_no), tree_leaves(p_rb)):
        assert torch.equal(a, b)


def test_rebalance_and_hot_row_config_guards():
    with pytest.raises(ValueError, match="rebalance"):
        _run(_cfg(num_workers=2, total_grads=10, shards=1, rebalance=True))
    kw = dict(num_workers=2, total_grads=10, shards=2, rebalance=True)
    with pytest.raises(ValueError, match="gap"):
        _run(_cfg(record_telemetry=False, **kw), name="ga-asgd")
    with pytest.raises(ValueError, match="telemetry"):
        _run(_cfg(record_telemetry=True, **kw))
    with pytest.raises(ValueError, match="one entry per worker"):
        _run(_cfg(hot_rows=((0, 8),)))
    with pytest.raises(ValueError, match="invalid"):
        _run(_cfg(mode="free", hot_rows=((0, 8), (8, 8), None, None)))
    with pytest.raises(ValueError, match="invalid"):
        _run(_cfg(mode="free", hot_rows=((0, 17), None, None, None)))
    # the tree path (deterministic, no kernel) cannot honour a range
    with pytest.raises(ValueError, match="flat kernel"):
        _run(_cfg(hot_rows=((0, 8), None, None, None)))
    # a rebalancing run drops hot rows (ranges move) and still completes
    stats = {}
    _run(_cfg(mode="free", coalesce=2, shards=2, rebalance=True,
              record_telemetry=False, hot_rows=((0, 8),) * 4),
         stats=stats)
    assert stats["applied"] == 60
