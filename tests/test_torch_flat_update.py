"""The port's flat master update and send view against the JAX package's.

* The plain batched update (``ref.py``) equals the eager JAX reference
  (``jax.disable_jit()``) BIT FOR BIT in every elementwise mode: both
  compute the same f32 operations in the same order.  The weighted hat
  sums N slab rows with ``tensordot`` in both packages, in orders that
  need not agree: rtol=1e-6, atol=1e-7.
* Against the JAX Pallas kernels run as the JAX package's own tests run
  them on the CPU (``interpret=True``, under jit): rtol=1e-6, atol=1e-6,
  because XLA contracts a*b+c into FMAs inside the jitted kernels.  The
  delay-compensated mode gets rtol=atol=1e-5: its term lam*g^2*(theta -
  sent) multiplies that one-rounding difference by lam*g^2 (about 30 at
  these inputs), and chains it through the duplicate ids.
* On CPU tensors the wrappers take the plain version and launch nothing;
  the CUDA-only kernel wrappers refuse CPU tensors (no fallback).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms import make_algorithm as jmake
from repro.core.schedules import Schedule as JSchedule
from repro.core.types import HyperParams as JHP
from repro.kernels.flat_update import FlatAlgorithm as JFlat
from repro.kernels.flat_update import ops as jops
from repro.kernels.flat_update.kernel import (
    flat_master_update_batch_2d, flat_master_update_batch_prefetch)
from repro.kernels.flat_update.ref import (
    flat_master_update_batch_ref as jref)
from repro.kernels.flat_update.send import flat_send_view as jsend
from repro.kernels.flat_update.send import flat_send_view_ref as jsend_ref

from repro_torch.convert import flat_state_from_numpy
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.schedules import Schedule
from repro_torch.core.types import HyperParams
from repro_torch.core.algorithms import REGISTRY
from repro_torch.kernels.flat_update import (FLAT_ELIGIBLE, SEND_KERNEL,
                                             FlatAlgorithm,
                                             flat_master_update_batch,
                                             kernel_eligible,
                                             flat_send_view,
                                             flat_send_view_ref, launches,
                                             reset_launches)
from repro_torch.kernels.flat_update.kernel import flat_update_batch
from repro_torch.kernels.flat_update.ref import flat_master_update_batch_ref

# These checks run on tiny tensors, where extra intra-op threads only
# spin; one thread keeps them from taking cores from the timed
# benchmark smoke that runs beside them under pytest-xdist.
torch.set_num_threads(1)

R, N, K = 24, 6, 8
IDS = [3, 1, 3, 5, 0, 1, 2, 3]          # duplicates chain


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _inputs(seed=0, n=N, k=K):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    v = f(n, R, 128) * 0.1
    ins = {"theta": f(R, 128), "v": v, "v0": v.sum(0),
           "u2": np.abs(f(R, 128)) * 0.01,
           "sent": None, "g": f(k, R, 128)}
    ins["sent"] = ins["theta"] + 0.01 * f(n, R, 128)
    scal = {"lrs": np.linspace(0.05, 0.03, k).astype(np.float32),
            "lrs_next": np.linspace(0.049, 0.029, k).astype(np.float32),
            "gammas": np.full(k, 0.9, np.float32),
            "cgs": np.full(k, 0.95, np.float32),
            "vscales": np.linspace(1.0, 0.8, k).astype(np.float32)}
    scal["hcs"] = (scal["lrs_next"] * scal["gammas"]) * scal["vscales"]
    weights = (rng.random((k, n)) + 0.5).astype(np.float32)
    return ins, scal, weights


# name: (nesterov, v0, u2, sent: None | "dc" | "dc+view", hat, telemetry)
MODES = {
    "multi-asgd": (False, False, False, None, "theta", False),
    "dana-slim": (True, False, False, None, "theta", False),
    "dana-zero": (False, True, False, None, "v0", False),
    "dana-zero+telemetry": (False, True, False, None, "v0", True),
    "dana-nadam": (True, True, True, None, "v0", False),
    "nadam-asgd": (True, False, True, None, "theta", False),
    "dc-asgd": (False, False, False, "dc", "theta", True),
    "dana-dc": (False, True, False, "dc+view", "v0", False),
    "lwp": (False, False, False, None, "self", False),
    "dana-hetero": (False, True, False, None, "weighted", False),
}


def _call_both(mode, seed=0):
    nest, use_v0, use_u2, sent, hat, tel = MODES[mode]
    ins, scal, weights = _inputs(seed)
    pick = lambda key, on: ins[key] if on else None
    state = [ins["theta"], ins["v"], pick("v0", use_v0), pick("u2", use_u2),
             pick("sent", sent is not None)]
    kw = dict(nesterov=nest, dc_lambda=2.0 if sent else None,
              sent_view=sent == "dc+view", hat_mode=hat, telemetry=tel,
              weights=weights if hat == "weighted" else None)
    ids = np.asarray(IDS)
    sc = (scal["lrs"], scal["lrs_next"], scal["gammas"], scal["cgs"],
          scal["vscales"])
    T = lambda a: None if a is None else torch.from_numpy(a.copy())
    port = flat_master_update_batch_ref(
        *map(T, state), None, T(ins["g"]), ids, *sc, hcs=scal["hcs"], **kw)
    J = lambda a: None if a is None else jnp.asarray(a)
    with jax.disable_jit():
        ref = jref(*map(J, state), None, J(ins["g"]), jnp.asarray(ids,
                   jnp.int32), *map(jnp.asarray, sc),
                   hcs=jnp.asarray(scal["hcs"]),
                   **{**kw, "weights": J(kw["weights"])})
    return port, ref, (state, ins, scal, ids, kw)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_batched_update_matches_eager_jax_reference(mode):
    port, ref, _ = _call_both(mode)
    for a, b in zip(port, ref):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if MODES[mode][4] == "weighted":
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
        else:
            _bits_equal(a, b)


@pytest.mark.parametrize("pallas", ["2d", "prefetch"])
@pytest.mark.parametrize("mode", ["dana-zero+telemetry", "dana-nadam",
                                  "dana-dc", "dana-hetero"])
def test_plain_batched_update_matches_pallas_interpret(mode, pallas):
    port, _, (state, ins, scal, ids, kw) = _call_both(mode, seed=1)
    fn = (flat_master_update_batch_2d if pallas == "2d"
          else flat_master_update_batch_prefetch)
    J = lambda a: None if a is None else jnp.asarray(a)
    outs = fn(*map(J, state), J(ins["g"]), jnp.asarray(ids, jnp.int32),
              *(jnp.asarray(scal[x]) for x in ("lrs", "lrs_next", "gammas",
                                               "cgs", "vscales")),
              hcs=jnp.asarray(scal["hcs"]),
              **{**kw, "weights": J(kw["weights"])}, interpret=True)
    port = port[:5] + port[6:]                # drop avg_step
    tol = 1e-5 if kw["dc_lambda"] else 1e-6
    for a, b in zip(port, outs):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=tol, atol=tol)


def test_plain_update_is_in_place_and_copies_the_row_before_writing():
    ins, scal, _ = _inputs(2)
    T = lambda a: torch.from_numpy(a.copy())
    theta, v, v0 = T(ins["theta"]), T(ins["v"]), T(ins["v0"])
    out = flat_master_update_batch_ref(
        theta, v, v0, None, None, None, T(ins["g"]), IDS, scal["lrs"],
        scal["lrs_next"], scal["gammas"], scal["cgs"], scal["vscales"],
        nesterov=False, hcs=scal["hcs"])
    assert out[0] is theta and out[1] is v and out[2] is v0
    # v0 keeps tracking the sum of the rows (the view hazard)
    np.testing.assert_allclose(v0.numpy(), v.sum(0).numpy(), atol=1e-5)


@pytest.mark.parametrize("n,adaptive", [(1, False), (1, True), (4, False),
                                        (4, True)])
def test_send_view_plain_matches_jax(n, adaptive):
    rng = np.random.default_rng(n + 10 * adaptive)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    theta, slab = f(R, 128), f(n, R, 128)
    w = np.ones(n, np.float32) if n == 1 else (rng.random(n) + 0.5) \
        .astype(np.float32)
    u2 = np.abs(f(R, 128)) * 0.01 if adaptive else None
    c = np.float32(0.05) * np.float32(0.9)
    port = flat_send_view_ref(torch.from_numpy(theta),
                              torch.from_numpy(slab), torch.from_numpy(w),
                              c, None if u2 is None else torch.from_numpy(u2))
    J = lambda a: None if a is None else jnp.asarray(a)
    with jax.disable_jit():
        eager = jsend_ref(J(theta), J(slab), J(w), jnp.float32(c), J(u2))
    if n == 1:
        _bits_equal(port, eager)
    else:
        # N-way tensordot: the two libraries may sum in other orders
        np.testing.assert_allclose(port.numpy(), np.asarray(eager),
                                   rtol=1e-6, atol=1e-7)
    pallas = jsend(J(theta), J(slab), J(w), jnp.float32(c), J(u2),
                   use_pallas=True)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), rtol=1e-6,
                               atol=1e-6)


def test_cpu_wrappers_run_the_plain_version_and_launch_nothing():
    reset_launches()
    port, _, (state, ins, scal, ids, kw) = _call_both("dana-zero")
    T = lambda a: None if a is None else torch.from_numpy(a.copy())
    out = flat_master_update_batch(
        *map(T, state), T(ins["g"]), ids, scal["lrs"], scal["gammas"],
        scal["cgs"], scal["vscales"], scal["hcs"], **kw)
    for a, b in zip(out, port[:5] + port[6:]):
        if a is not None:
            _bits_equal(a, b)
    theta, v0 = T(ins["theta"]), T(ins["v0"])
    w = torch.ones(1)
    view = flat_send_view(theta, v0[None], w, np.float32(0.04))
    _bits_equal(view, flat_send_view_ref(theta, v0[None], w,
                                         np.float32(0.04)))
    assert launches() == {"flat_update_batch": 0, "send_view": 0}
    with pytest.raises(ValueError, match="CUDA"):
        flat_update_batch(*map(T, state), T(ins["g"]), ids, scal["lrs"],
                          scal["gammas"], scal["cgs"], scal["vscales"],
                          scal["hcs"], **kw)
    meta = torch.empty((R, 128), device="meta")
    with pytest.raises(ValueError, match="device"):
        flat_send_view(meta, meta[None], w, 1.0)
    assert launches() == {"flat_update_batch": 0, "send_view": 0}


FLAT_ALGOS = ["asgd", "nag-asgd", "multi-asgd", "dana-zero", "dana-slim",
              "sa-asgd", "dc-asgd", "lwp", "dana-dc", "dana-hetero",
              "nadam-asgd", "dana-nadam", "ga-asgd"]
# reductions that sum in another order than the JAX package's: the
# N-way tensordot of dana-hetero's weighted hat, and ga-asgd's gap and
# step norms (the JAX package holds its own gap kernel to the same
# tolerance); every other member is elementwise and bit-exact
REDUCING = {"dana-hetero": dict(rtol=1e-6, atol=1e-7),
            "ga-asgd": dict(rtol=2e-6, atol=2e-7)}
FLAT_KEYS = ("theta", "v", "v0", "u2", "sent", "avg_step", "wscal", "rate",
             "lr_prev", "vscale", "tau")


@pytest.mark.parametrize("name", FLAT_ALGOS)
def test_flat_algorithm_batches_bit_equal_to_eager_jax(name):
    """Host-side per-message scalars (moving schedule, vscale chain, hat
    coefficients, staleness lane, rate lane) and the batched plain update
    against the JAX FlatAlgorithm on its reference path, from one
    converted state."""
    tol = REDUCING.get(name)

    def same(a, b):
        if tol is None:
            _bits_equal(a, b)
        else:
            np.testing.assert_allclose(np.asarray(a, np.float32),
                                       np.asarray(b, np.float32), **tol)

    rng = np.random.default_rng(3)
    params = [{"w": rng.standard_normal((9, 7)).astype(np.float32),
               "b": rng.standard_normal(7).astype(np.float32)},
              {"w": rng.standard_normal((7, 5)).astype(np.float32),
               "b": rng.standard_normal(5).astype(np.float32)}]
    sc = dict(base_lr=0.05, num_workers=4, warmup_steps=5, milestones=(7,),
              decay_factor=0.5)
    jfa = JFlat(jmake(name, JHP(lr=0.05), JSchedule(**sc)), use_pallas=False)
    tfa = FlatAlgorithm(make_algorithm(name, HyperParams(lr=0.05),
                                       Schedule(**sc)))
    with jax.disable_jit():
        js = jfa.init(jax.tree.map(jnp.asarray, params), 4)
        ts = tfa.adopt(tfa.algo.init(
            jax.tree.map(torch.from_numpy, params), 4))
        jv, js = jfa.send_flat(js, jnp.int32(1))   # a pull: stamps lanes
        tv, ts = tfa.send_flat(ts, 1)
        same(tv, jv)
        now = 0.0
        for batch in ([0, 2, 0], [3], [1, 1, 2, 3]):
            g = rng.standard_normal((len(batch), tfa.spec.rows, 128)) \
                .astype(np.float32)
            g[:, -1] = 0.0                      # the padding tail stays 0
            nows = now + np.cumsum(rng.random(len(batch)) + 0.2)
            now = float(nows[-1])
            js, jh, _ = jfa.apply_batch(js, jnp.asarray(batch, jnp.int32),
                                        jnp.asarray(g),
                                        jnp.asarray(nows, jnp.float32))
            ts, th, _ = tfa.apply_batch(ts, batch, torch.from_numpy(g),
                                        nows)
            same(torch.stack(th), jh)
            assert ts["t"] == int(js["t"])
            for key in FLAT_KEYS:
                assert (key in ts) == (key in js), key
                if key in js:
                    same(ts[key], js[key])
        jv, js = jfa.send_flat(js, jnp.int32(2))
        tv, ts = tfa.send_flat(ts, 2)
        same(tv, jv)
        for key in ("sent", "wscal"):
            if key in js:
                same(ts[key], js[key])
        stale = tfa.staleness(ts)
        assert (stale is None) == (jfa.staleness(js) is None)
        if stale is not None:
            _bits_equal(stale, jfa.staleness(js))
            _bits_equal(tfa.batch_staleness(ts, [2, 0, 2], 3),
                        jfa.batch_staleness(js, jnp.asarray([2, 0, 2]), 3))
    # the JAX state converted through numpy steps on as the port's own
    conv = flat_state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                                 "cpu")
    assert set(conv) == set(ts)
    for key, val in ts.items():
        if isinstance(val, torch.Tensor):
            assert conv[key].dtype == val.dtype and conv[key].shape == val.shape
            same(conv[key], val)
        elif isinstance(val, np.ndarray):        # a host scalar lane
            assert conv[key].dtype == val.dtype
            same(conv[key], val)
        else:
            assert conv[key] == val and type(conv[key]) is type(val)


@pytest.mark.parametrize("name", ["dana-zero", "lwp", "dana-nadam"])
def test_unit_weight_sends_reuse_one_weights_tensor(name, monkeypatch):
    """Repeated unit-weight sends pass the same weights tensor (made at
    the first send, not allocated and filled at every send) and still
    equal the JAX package's send."""
    from repro_torch.kernels.flat_update import ops as tops
    seen = []
    real = tops.flat_send_view

    def spy(theta, slab, w, c, u2=None, **kw):
        seen.append(w)
        return real(theta, slab, w, c, u2, **kw)

    monkeypatch.setattr(tops, "flat_send_view", spy)
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((9, 7)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    jfa = JFlat(jmake(name, JHP(lr=0.05)), use_pallas=False)
    tfa = FlatAlgorithm(make_algorithm(name, HyperParams(lr=0.05)))
    with jax.disable_jit():
        js = jfa.init(jax.tree.map(jnp.asarray, params), 3)
        ts = tfa.adopt(tfa.algo.init(
            jax.tree.map(torch.from_numpy, params), 3))
        for step, i in enumerate((0, 2, 1, 0)):
            g = rng.standard_normal((1, tfa.spec.rows, 128)) \
                .astype(np.float32)
            g[:, -1] = 0.0
            js, _, _ = jfa.apply_batch(js, jnp.asarray([i], jnp.int32),
                                       jnp.asarray(g),
                                       jnp.asarray([step + 1.0],
                                                   jnp.float32))
            ts, _, _ = tfa.apply_batch(ts, [i], torch.from_numpy(g),
                                       np.asarray([step + 1.0]))
            jv, js = jfa.send_flat(js, jnp.int32(i))
            tv, ts = tfa.send_flat(ts, i)
            _bits_equal(tv, jv)
    assert len(seen) == 4 and all(w is seen[0] for w in seen)
    assert seen[0].dtype == torch.float32 and seen[0].tolist() == [1.0]


def test_flat_eligibility_equals_the_jax_package():
    """Every registered member but the four off-flat ones has a flat
    path, and the same members as in the JAX package build their send
    view with the send kernel."""
    assert FLAT_ELIGIBLE == jops.FLAT_ELIGIBLE
    assert SEND_KERNEL == jops.SEND_KERNEL
    off_flat = {"ssgd", "easgd", "dana-easgd", "yellowfin"}
    assert sorted(set(REGISTRY) - off_flat) == sorted(FLAT_ELIGIBLE)
    for name in off_flat:
        assert not kernel_eligible(make_algorithm(name))
        assert not jops.kernel_eligible(jmake(name))
    for name in FLAT_ELIGIBLE:
        algo = make_algorithm(name)
        assert kernel_eligible(algo)
        fa, jfa = FlatAlgorithm(algo), JFlat(jmake(name))
        assert (fa.send_spec.source is not None) == (name in SEND_KERNEL)
        assert fa.send_spec.hat_mode == jfa.send_spec.hat_mode
        for field in ("sent_key", "sent_view", "gap_aware", "rate_weighted",
                      "staleness_lr", "uses_vscale", "nesterov",
                      "shared_momentum", "u2_key", "sum_key"):
            assert getattr(fa.fam, field) == getattr(jfa.fam, field), field
