"""The port's row-sharded master (``cluster/sharded.py``): the
counterparts of the JAX package's ``tests/test_sharded.py``.

* ``row_ranges`` and ``eligibility_matrix()`` equal the JAX package's
  exactly; ``slice_flat`` / ``merge_flat`` round trips.
* S shards applying the same message sequence reproduce the port's
  single flat master BIT FOR BIT (state and every reply view) for the
  12 elementwise members, S in {1, 2, 4}, duplicate ids included.
* ga-asgd's exchanged norms sum per shard in another order than the
  single master's full sum: held at rtol 2e-6 / atol 2e-7 (ROADMAP.md
  C10's yardstick), driven synchronously and by real shard threads.
* The deterministic sharded cluster equals the port's engine (flat
  path) bit for bit; the JAX package's own version of this check fails
  by an FMA (C14), so the port's is held against the port's engine.
* One state-level comparison against the JAX ``ShardedMaster`` on the
  same messages (jitted there: rtol 1e-5, atol 1e-6).
* Faults, eval watermarks, the fan-out pull and the guards.

Shard and worker threads are real: every wait is bounded by a small
``rpc_timeout`` or join timeout.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import ShardedMaster as JSharded
from repro.core.algorithms import make_algorithm as jmake
from repro.core.flat import FlatSpec as JFlatSpec
from repro.core.metrics import History as JHistory
from repro.core.types import HyperParams as JHP
from repro.kernels.flat_update import eligibility_matrix as jeligibility

from repro_torch.cluster import (ClusterConfig, FaultInjector, FaultPlan,
                                 GradMsg, Mailbox, Master, ShardedMaster,
                                 run_cluster)
from repro_torch.cluster.mailbox import FanoutMailbox
from repro_torch.convert import params_from_numpy
from repro_torch.core.algorithms import REGISTRY, make_algorithm
from repro_torch.core.engine import SimulationConfig, run_simulation
from repro_torch.core.flat import FlatSpec
from repro_torch.core.gamma import GammaModel
from repro_torch.core.metrics import History
from repro_torch.core.types import HyperParams, tree_leaves
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.kernels.flat_update import (eligibility_matrix,
                                             kernel_eligible, merge_flat,
                                             shard_bitexact, slice_flat)
from repro_torch.models.toy import make_classifier_fns

torch.set_num_threads(1)

HP = HyperParams(lr=0.05, momentum=0.9)
DIMS = [16, 64, 4]          # 1348 parameters: 11 rows of 16 are real
TASK = ClassificationTask(dim=16, num_classes=4, batch_size=8, seed=3,
                          device="cpu")
_, GRAD_FN, MAKE_EVAL = make_classifier_fns(DIMS)
EVAL_FN = MAKE_EVAL(TASK.eval_batch(32))
RPC = 20.0
GAP_TOL = dict(rtol=2e-6, atol=2e-7)

ELIGIBLE = sorted(n for n in REGISTRY if kernel_eligible(make_algorithm(n)))
ELEMENTWISE = sorted(n for n in ELIGIBLE
                     if shard_bitexact(make_algorithm(n)))
# duplicate worker ids inside one batch: momentum chaining across shards
BATCHES = [([1, 3, 1, 0], 11), ([2, 2, 2, 2], 29), ([0, 1, 2, 3], 47)]


def _params0_np(seed=1):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(DIMS[:-1], DIMS[1:])]


def _params0():
    return params_from_numpy(_params0_np(), "cpu")


def _grads(k, seed):
    p = _params0()
    return [GRAD_FN(p, TASK.batch(j % 3, seed + j)) for j in range(k)]


def _cfg(**kw):
    base = dict(num_workers=4, total_grads=60, eval_every=20,
                exec_model=GammaModel(seed=5), rpc_timeout=RPC,
                device="cpu")
    base.update(kw)
    return ClusterConfig(**base)


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _state_equal(a, b, tol=None):
    assert set(a) == set(b)
    for key in a:
        for x, y in zip(tree_leaves(a[key]) if isinstance(a[key], (
                dict, list, torch.Tensor)) else [a[key]],
                tree_leaves(b[key]) if isinstance(b[key], (
                    dict, list, torch.Tensor)) else [b[key]]):
            x, y = np.asarray(x), np.asarray(y)
            if tol is None:
                np.testing.assert_array_equal(x, y, err_msg=key)
            else:
                np.testing.assert_allclose(x, y, err_msg=key, **tol)


def _msgs(ids, grads):
    return [GradMsg(w, g, None, 0, 0.0) for w, g in zip(ids, grads)]


def _drive_single(name, n=4):
    """BATCHES through the single flat master's serve-loop apply."""
    algo = make_algorithm(name, HP)
    m = Master(algo, algo.init(_params0(), n), mailbox=Mailbox(),
               history=History(), stop=threading.Event(), total_grads=100,
               coalesce=8, use_kernel=True, record_telemetry=False)
    spec, views = m._flat_algo.spec, []
    for ids, seed in BATCHES:
        msgs = _msgs(ids, [spec.pack(g) for g in _grads(len(ids), seed)])
        m._apply(msgs)
        views += [mm.wait_reply(1.0).view for mm in msgs]
    return m, views


def _sharded(name, shards, n=4, **kw):
    algo = make_algorithm(name, HP)
    kw.setdefault("record_telemetry", False)
    return ShardedMaster(algo, algo.init(_params0(), n), shards=shards,
                         history=History(), stop=threading.Event(),
                         total_grads=100, coalesce=8, **kw)


def _drive_sharded(name, shards, perm_shard=None, perm=None):
    """BATCHES shard by shard (optionally permuting ONE shard's order,
    the out-of-order-delivery fault)."""
    sm = _sharded(name, shards)
    views = []
    for ids, seed in BATCHES:
        gf = [sm.spec.pack(g) for g in _grads(len(ids), seed)]
        per_shard = []
        for srv in sm.shards_:
            order = (perm if perm is not None and srv.sid == perm_shard
                     else range(len(ids)))
            msgs = [GradMsg(ids[j], gf[j][srv.r0:srv.r1], None, 0, 0.0)
                    for j in order]
            srv._apply(msgs)
            per_shard.append([mm.wait_reply(1.0).view for mm in msgs])
        views += [torch.cat([per_shard[s][j] for s in range(shards)])
                  for j in range(len(ids))]
    return sm, views


# ---------------------------------------------------------------------------
# the layout helpers and the contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5, 7, 8])
def test_row_ranges_equal_the_jax_package(shards):
    """Python's rounding (half to even) and the row_align snap, as the
    JAX package computes them, for states from 8 to 1032 rows."""
    for n_elems in (1000, 1024 * 3 + 5, 128 * 200, 128 * 1032):
        for align in (1, 8):
            tree = {"x": np.zeros((n_elems,), np.float32)}
            spec = FlatSpec.from_tree(
                {"x": torch.zeros(n_elems)}, row_align=align)
            jspec = JFlatSpec.from_tree(
                jax.tree.map(jnp.asarray, tree), row_align=align)
            assert spec.rows == jspec.rows
            if shards > spec.rows:
                with pytest.raises(ValueError):
                    spec.row_ranges(shards)
                continue
            assert spec.row_ranges(shards) == jspec.row_ranges(shards)


def test_eligibility_matrix_equals_the_jax_package():
    assert eligibility_matrix() == jeligibility()
    assert len(eligibility_matrix()) == 17
    assert len(ELEMENTWISE) == 12 and "ga-asgd" not in ELEMENTWISE


@pytest.mark.parametrize("name", ["dana-zero", "dc-asgd", "ga-asgd",
                                  "dana-hetero", "dana-nadam"])
def test_slice_and_merge_round_trip(name):
    algo = make_algorithm(name, HP)
    m = Master(algo, algo.init(_params0(), 3), mailbox=Mailbox(),
               history=History(), stop=threading.Event(), total_grads=1,
               use_kernel=True)
    flat, spec = m._flat_state, m._flat_algo.spec
    ranges = spec.row_ranges(3)
    pieces = [slice_flat(flat, r0, r1) for r0, r1 in ranges]
    for p, (r0, r1) in zip(pieces, ranges):
        assert p["theta"].shape[0] == r1 - r0 and p["v"].is_contiguous()
        # copies: writing a piece leaves the state alone
        assert p["theta"].data_ptr() != flat["theta"].data_ptr()
    back = merge_flat(pieces)
    assert set(back) == set(flat)
    for key, val in flat.items():
        if isinstance(val, torch.Tensor):
            assert torch.equal(back[key], val), key
        else:
            np.testing.assert_array_equal(np.asarray(back[key]),
                                          np.asarray(val))
    # subspec takes exactly its rows, as views
    full = spec.pack(_params0())
    assert torch.equal(spec.concat_rows(
        [spec.subspec(r0, r1).take(full) for r0, r1 in ranges]), full)
    assert spec.subspec(*ranges[1]).take(full).data_ptr() == \
        full[ranges[1][0]].data_ptr()


# ---------------------------------------------------------------------------
# equivalence: sharded == single flat master
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("name", ELEMENTWISE)
def test_sharded_equals_single_master(name, shards):
    single, views_s = _drive_single(name)
    sharded, views_h = _drive_sharded(name, shards)
    _equal_trees(single.master_params(), sharded.master_params())
    _state_equal(single.state, sharded.state)
    assert len(views_s) == len(views_h) == 12
    for a, b in zip(views_s, views_h):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_gap_exchange_matches_single_master(shards):
    """ga-asgd's steps driven synchronously: the S partials summed in
    shard order, applied per shard, the update norms summed, the EMA
    finished."""
    single, views_s = _drive_single("ga-asgd")
    sm = _sharded("ga-asgd", shards)
    fa, views_h = sm._flat_algo, []
    for ids, seed in BATCHES:
        gf = [sm.spec.pack(g) for g in _grads(len(ids), seed)]
        for wid, g in zip(ids, gf):
            total = np.float32(0.0)
            for srv in sm.shards_:
                total = np.float32(total + np.float32(float(
                    fa.gap_partial(srv.state, wid))))
            outs = [fa.apply_gap_message(srv.state, wid,
                                         g[srv.r0:srv.r1], float(total))
                    for srv in sm.shards_]
            vn2 = np.float32(0.0)
            for o in outs:
                vn2 = np.float32(vn2 + np.float32(float(o[2])))
            for srv, (st, hat, _, lr, vs, _, _) in zip(sm.shards_, outs):
                srv.state = fa.finish_gap_message(st, float(vn2), lr, vs)
            views_h.append(torch.cat([o[1] for o in outs]))
    _state_equal(single.state, sm.state, GAP_TOL)
    for a, b in zip(views_s, views_h):
        torch.testing.assert_close(b, a, **GAP_TOL)
    if shards == 1:
        # one shard sums the full norm: the single master's bits
        _state_equal(single.state, sm.state)


def test_sharded_gap_batched_exchange_matches_single_master():
    """Two shard threads draining real batches through ``_apply`` (the
    norm exchange, two combines a message)."""
    single, views_s = _drive_single("ga-asgd")
    sm = _sharded("ga-asgd", 2)
    views = [[], []]
    for ids, seed in BATCHES:
        gf = [sm.spec.pack(g) for g in _grads(len(ids), seed)]
        per = [[GradMsg(w, g[srv.r0:srv.r1], None, 0, 0.0)
                for w, g in zip(ids, gf)] for srv in sm.shards_]
        threads = [threading.Thread(target=srv._apply, args=(msgs,))
                   for srv, msgs in zip(sm.shards_, per)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for s, msgs in enumerate(per):
            views[s] += [m.wait_reply(1.0).view for m in msgs]
    _state_equal(single.state, sm.state, GAP_TOL)
    for j, a in enumerate(views_s):
        torch.testing.assert_close(torch.cat([views[0][j], views[1][j]]),
                                   a, **GAP_TOL)


def _jax_sharded(name, shards):
    """The JAX ShardedMaster on the same numpy parameters and the same
    packed gradients as ``_drive_sharded``."""
    jalgo = jmake(name, JHP(lr=0.05, momentum=0.9))
    jp0 = jax.tree.map(jnp.asarray, _params0_np())
    sm = JSharded(jalgo, jalgo.init(jp0, 4), shards=shards,
                  history=JHistory(), stop=threading.Event(),
                  total_grads=100, coalesce=8, record_telemetry=False)
    for ids, seed in BATCHES:
        gf = [jnp.asarray(FlatSpec.from_tree(_params0()).pack(g).numpy())
              for g in _grads(len(ids), seed)]
        if name == "ga-asgd":
            for wid, g in zip(ids, gf):
                i32 = jnp.int32(wid)
                gap2 = float(np.float32(sum(
                    np.float32(float(srv._gap_partial_jit(srv.state, i32)))
                    for srv in sm.shards_)))
                outs = [srv._gap_apply_jit(srv.state, i32,
                                           g[srv.r0:srv.r1],
                                           jnp.float32(gap2), None)
                        for srv in sm.shards_]
                vn2 = float(np.float32(sum(np.float32(float(o[2]))
                                           for o in outs)))
                for srv, o in zip(sm.shards_, outs):
                    srv.state = srv._gap_finish_jit(
                        o[0], jnp.float32(vn2), o[3], o[4])
            continue
        for srv in sm.shards_:
            fn = srv._get_fused(len(ids), False)
            srv.state, _, _, _ = fn(
                srv.state, jnp.asarray(ids, jnp.int32),
                jnp.zeros((len(ids),), jnp.float32),
                jnp.stack([g[srv.r0:srv.r1] for g in gf]), None)
    return sm


@pytest.mark.parametrize("name", ["dana-zero", "ga-asgd"])
def test_sharded_state_matches_the_jax_sharded_master(name):
    tol = dict(rtol=1e-5, atol=1e-6)
    if name == "ga-asgd":
        sm = _sharded(name, 2)
        fa = sm._flat_algo
        for ids, seed in BATCHES:
            gf = [sm.spec.pack(g) for g in _grads(len(ids), seed)]
            for wid, g in zip(ids, gf):
                per = [GradMsg(wid, g[srv.r0:srv.r1], None, 0, 0.0)
                       for srv in sm.shards_]
                threads = [threading.Thread(target=srv._apply, args=([m],))
                           for srv, m in zip(sm.shards_, per)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
        assert fa.fam.gap_aware
    else:
        sm, _ = _drive_sharded(name, 2)
    jsm = _jax_sharded(name, 2)
    assert sm.ranges == jsm.ranges
    ts, js = sm.state, jsm.state
    for key in js:
        for a, b in zip(tree_leaves(ts[key]) if not np.isscalar(ts[key])
                        else [ts[key]], jax.tree.leaves(js[key])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       err_msg=key, **tol)


# ---------------------------------------------------------------------------
# the threaded cluster
# ---------------------------------------------------------------------------
def _run(name, *, stats=None, eval_fn=EVAL_FN, **kw):
    return run_cluster(make_algorithm(name, HP), GRAD_FN, _params0_np(),
                       TASK.batch, _cfg(**kw), eval_fn, stats_out=stats)


def test_sharded_deterministic_cluster_matches_engine():
    """Deterministic sharded (S=3) replays the port's engine on the flat
    path bit for bit: parameters, events, eval losses; the gap row sums
    S partials (float tolerance)."""
    h_e = run_simulation(
        make_algorithm("dana-zero", HP), GRAD_FN, _params0_np(),
        TASK.batch, SimulationConfig(num_workers=4, total_grads=80,
                                     eval_every=20,
                                     exec_model=GammaModel(seed=5),
                                     use_kernel=True, device="cpu"),
        EVAL_FN)
    stats = {}
    h_c = _run("dana-zero", total_grads=80, shards=3, stats=stats)
    _equal_trees(h_e.final_params, h_c.final_params)
    for key in ("time", "worker", "lag", "step", "eval_step", "eval_loss"):
        assert getattr(h_c, key) == getattr(h_e, key), key
    np.testing.assert_allclose(h_c.gap, h_e.gap, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(h_c.grad_norm, h_e.grad_norm, rtol=1e-5)
    assert stats["shard_applied"] == [80] * 3 and stats["flat"]


@pytest.mark.parametrize("name", ["multi-asgd", "dana-nadam", "dana-dc",
                                  "lwp", "dana-hetero", "sa-asgd"])
def test_sharded_deterministic_matches_single_flat(name):
    def run(shards):
        return _run(name, num_workers=3, shards=shards, use_kernel=True,
                    record_telemetry=False, eval_fn=None)
    _equal_trees(run(1).final_params, run(4).final_params)


def test_sharded_gap_deterministic_cluster_matches_single():
    def run(shards):
        return _run("ga-asgd", shards=shards, use_kernel=True,
                    record_telemetry=False, eval_fn=None)
    for a, b in zip(tree_leaves(run(1).final_params),
                    tree_leaves(run(3).final_params)):
        torch.testing.assert_close(b, a, rtol=5e-6, atol=5e-7)


@pytest.mark.parametrize("name", ["dana-slim", "ga-asgd"])
def test_sharded_free_mode_completes(name):
    stats = {}
    hist = _run(name, num_workers=8, total_grads=240, mode="free",
                coalesce=4, shards=4, record_telemetry=False, eval_fn=None,
                stats=stats)
    assert stats["applied"] == 240 and stats["shards"] == 4
    assert stats["shard_applied"] == [240] * 4
    assert len(stats["shard_busy_s"]) == 4
    assert sum(stats["grads_per_worker"].values()) == 240
    assert hist.final_params is not None


def test_sharded_live_telemetry_and_eval():
    hist = _run("dana-zero", total_grads=120, mode="free", coalesce=2,
                shards=2, eval_every=40)
    assert len(hist.time) == len(hist.gap) == len(hist.lag) == 120
    assert all(lag >= 0 for lag in hist.lag)
    assert sorted(hist.step) == list(range(1, 121))
    assert hist.eval_loss


def test_eval_watermark_consistency_under_coalescing():
    """With coalesce=8 > eval_every=3 drained batches straddle eval
    boundaries; chunks split at the watermark, so every eval sees the
    state at exactly a multiple of eval_every messages, on a k=1 master,
    a coalescing master and every shard of a sharded one."""
    total, every = 24, 3
    ids = [j % 4 for j in range(total)]
    grads = _grads(total, seed=9)

    def run(shards, coalesce):
        algo = make_algorithm("dana-zero", HP)
        stop = threading.Event()
        kw = dict(history=History(), stop=stop, total_grads=total,
                  coalesce=coalesce, eval_fn=EVAL_FN, eval_every=every,
                  record_telemetry=False)
        if shards == 1:
            mb = Mailbox()
            m = Master(algo, algo.init(_params0(), 4), mailbox=mb,
                       use_kernel=True, **kw)
            for wid, g in zip(ids, grads):
                mb.put(GradMsg(wid, m._flat_algo.spec.pack(g), None, 0,
                               0.0), stop)
        else:
            m = ShardedMaster(algo, algo.init(_params0(), 4),
                              shards=shards, **kw)
            for wid, g in zip(ids, grads):
                gf = m.spec.pack(g)
                m.frontdoor.put(GradMsg(wid, tuple(sub.take(gf)
                                                   for sub in m.subs),
                                        None, 0, 0.0), stop)
        m.serve()
        return m

    ref, deep, shard = run(1, 1), run(1, 8), run(2, 8)
    marks = list(range(every, total + 1, every))
    assert ref.history.eval_step == marks
    assert max(deep.coalesce_counts) > 1 and max(shard.coalesce_counts) > 1
    curve = dict(zip(ref.history.eval_step, ref.history.eval_loss))
    for m in (deep, shard):
        assert sorted(m.history.eval_step) == marks
        assert dict(zip(m.history.eval_step, m.history.eval_loss)) == curve


# ---------------------------------------------------------------------------
# fault isolation
# ---------------------------------------------------------------------------
def test_reorder_on_one_shard_leaves_others_bit_identical():
    clean, _ = _drive_sharded("dana-zero", 3)
    fault, _ = _drive_sharded("dana-zero", 3, perm_shard=0,
                              perm=[2, 0, 3, 1])
    assert not torch.equal(clean.shards_[0].state["theta"],
                           fault.shards_[0].state["theta"])
    for s in (1, 2):
        for key in ("theta", "v", "v0"):
            assert torch.equal(clean.shards_[s].state[key],
                               fault.shards_[s].state[key])


def test_reorder_targets_only_listed_shards():
    plan = FaultPlan(seed=2, reorder_prob=1.0, reorder_shards=(1,))
    inj = [FaultInjector(plan, 0, 32, shard_id=s) for s in range(2)]
    msgs = list(range(6))
    assert inj[0].reorder(msgs) == msgs
    assert sorted(inj[1].reorder(msgs)) == msgs
    # an independent substream per shard
    a = FaultInjector(FaultPlan(seed=2, reorder_prob=1.0), 0, 32,
                      shard_id=0)
    b = FaultInjector(FaultPlan(seed=2, reorder_prob=1.0), 0, 32,
                      shard_id=1)
    assert [a.reorder(msgs) for _ in range(4)] != \
        [b.reorder(msgs) for _ in range(4)]
    stats = {}
    hist = _run("dana-zero", num_workers=6, total_grads=180, mode="free",
                coalesce=4, shards=2, faults=plan, eval_fn=None,
                stats=stats)
    assert stats["applied"] == 180 and len(hist.step) == 180


def test_sharded_gap_reorder_reclamps_to_per_message():
    algo = make_algorithm("ga-asgd", HP)
    plan = FaultPlan(seed=2, reorder_prob=1.0, reorder_shards=(0,))
    sm = ShardedMaster(algo, algo.init(_params0(), 4), shards=2,
                       history=History(), stop=threading.Event(),
                       total_grads=10, coalesce=4, record_telemetry=False,
                       injectors=[FaultInjector(plan, 0, 32, shard_id=s)
                                  for s in range(2)])
    assert sm.coalesce == 1
    stats = {}
    _run("ga-asgd", total_grads=80, mode="free", coalesce=4, shards=2,
         record_telemetry=False, faults=FaultPlan(seed=2,
                                                  reorder_prob=1.0),
         eval_fn=None, stats=stats)
    assert stats["applied"] == 80


def test_sharded_stalls_deterministic_and_reproducible():
    def run(shards):
        return _run("dana-zero", shards=shards, use_kernel=True,
                    faults=FaultPlan(seed=3, stall_prob=0.25,
                                     stall_scale=4.0))
    h1, h2, hs = run(2), run(2), run(1)
    assert h1.time == h2.time == hs.time
    _equal_trees(h1.final_params, h2.final_params)
    _equal_trees(h1.final_params, hs.final_params)


def test_sharded_dropout_worker_rejoins():
    stats = {}
    _run("dana-slim", total_grads=240, mode="free", coalesce=2, shards=2,
         faults=FaultPlan(seed=1, dropout=((2, 20, 160),)),
         record_telemetry=False, eval_fn=None, stats=stats)
    counts = stats["grads_per_worker"]
    assert stats["applied"] == 240
    assert 0 < counts[2] < min(counts[w] for w in (0, 1, 3))


# ---------------------------------------------------------------------------
# plumbing and guards
# ---------------------------------------------------------------------------
def test_sharded_rejects_ineligible_and_no_kernel():
    algo = make_algorithm("easgd", HP)
    with pytest.raises(ValueError, match="eligible"):
        ShardedMaster(algo, algo.init(_params0(), 2), shards=2,
                      history=History(), stop=threading.Event(),
                      total_grads=10)
    with pytest.raises(ValueError, match="eligible"):
        _run("easgd", num_workers=2, total_grads=10, mode="free", shards=2)
    with pytest.raises(ValueError, match="flat kernel"):
        _run("dana-zero", num_workers=2, total_grads=10, mode="free",
             shards=2, use_kernel=False)
    with pytest.raises(ValueError, match="flat"):
        _run("dana-zero", num_workers=2, total_grads=10, shards=2,
             use_kernel=True, flat=False)
    with pytest.raises(ValueError, match="shard_ranges"):
        _run("dana-zero", shard_ranges=((0, 16),))
    with pytest.raises(ValueError, match="contiguous"):
        _run("dana-zero", shards=2, shard_ranges=((0, 1), (2, 16)))


def test_fanout_pull_gathers_all_shards():
    algo = make_algorithm("dana-zero", HP)
    sm = ShardedMaster(algo, algo.init(_params0(), 3), shards=3,
                       history=History(), stop=threading.Event(),
                       total_grads=10, record_telemetry=False)
    stop = threading.Event()
    msg = GradMsg(0, None, None, 0, 0.0)
    assert sm.frontdoor.put(msg, stop)
    for srv in sm.shards_:
        (m,) = srv.mailbox.drain_nowait()
        srv._pull_reply(m)
    reply = msg.wait_reply(5.0)
    assert isinstance(reply.view, tuple) and len(reply.view) == 3
    single = Master(algo, algo.init(_params0(), 3), mailbox=Mailbox(),
                    history=History(), stop=threading.Event(),
                    total_grads=10, use_kernel=True, record_telemetry=False)
    view, _ = single.initial_view(0)
    assert torch.equal(torch.cat(reply.view), view)
    boxes = [Mailbox(), Mailbox()]
    front = FanoutMailbox(boxes)
    front.put(GradMsg(0, None, None, 0, 0.0), stop)
    assert len(front) == 1 and all(len(b) == 1 for b in boxes)


def test_reply_group_fails_if_any_shard_fails():
    boxes = [Mailbox(), Mailbox()]
    rows = []
    front = FanoutMailbox(boxes, tele_cb=lambda **kw: rows.append(kw),
                          drop_cb=lambda: rows.append("drop"))
    stop = threading.Event()
    msg = GradMsg(1, (torch.zeros(2), torch.zeros(2)), None, 0, 0.0)
    front.put(msg, stop)
    (a,), (b,) = boxes[0].drain_nowait(), boxes[1].drain_nowait()
    a.group.add_telemetry(0, worker=1, step=1, lag=0, t=0.0, d2=1.0,
                          g2=4.0)
    from repro_torch.cluster.mailbox import Reply
    a.respond(Reply(view=torch.ones(1), step=1))
    b.respond(None)
    assert msg.wait_reply(1.0) is None and rows == ["drop"]
