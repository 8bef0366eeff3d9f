"""The port's core primitives against the JAX package's, on the CPU.

Inputs come from numpy with fixed seeds and go to both packages.  The
tree order, the flat layout, schedules, the gamma event model and the
five ported algorithms must agree BIT FOR BIT: the port computes the same
f32 operations in the same order (host float32 scalars where JAX has 0-d
f32 arrays), and the JAX side runs eagerly (``jax.disable_jit()``) so no
FMA contraction reorders its rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro.core.flat import RATE_LANE as JRATE_LANE
from repro.core.flat import FlatSpec as JFlatSpec
from repro.core.flat import ScalarLane as JScalarLane
from repro.core.gamma import GammaModel as JGamma
from repro.core.schedules import Schedule as JSchedule
from repro.core.schedules import momentum_correction as jmc
from repro.core.types import HyperParams as JHP

from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithms as talg
from repro_torch.core.flat import RATE_LANE, FlatSpec, ScalarLane
from repro_torch.core.gamma import GammaModel
from repro_torch.core.schedules import Schedule, momentum_correction
from repro_torch.core.types import (HyperParams, tree_flatten, tree_index,
                                    tree_leaves, tree_map, tree_set_index,
                                    tree_unflatten)

# These checks run on tiny tensors, where extra intra-op threads only
# spin; one thread keeps them from taking cores from the timed
# benchmark smoke that runs beside them under pytest-xdist.
torch.set_num_threads(1)


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_bits_equal(port_tree, jax_tree):
    lp, lj = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(lp) == len(lj)
    for a, b in zip(lp, lj):
        _bits_equal(_np(a), b)


def _ragged_tree(rng, scale=1.0):
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"zeta": [f(3, 5), {"b": f(7), "a": f(2, 3, 4)}],
            "alpha": f(), "mid": (f(11), None, f(1, 9))}


def _mlp(rng, dims):
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2 / a))
             .astype(np.float32), "b": rng.standard_normal(b)
             .astype(np.float32)} for a, b in zip(dims[:-1], dims[1:])]


# -- trees and the flat layout ------------------------------------------
@pytest.mark.parametrize("which", ["ragged", "mlp"])
def test_tree_flatten_order_is_jax_order(which):
    rng = np.random.default_rng(0)
    tree = _ragged_tree(rng) if which == "ragged" else _mlp(rng, [4, 3, 2])
    leaves, treedef = tree_flatten(tree)
    jleaves = jax.tree.leaves(tree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a is b
    assert tree_leaves(tree_unflatten(treedef, leaves)) == leaves
    if which == "mlp":
        assert leaves[0] is tree[0]["b"]       # sorted keys: [b, w]


@pytest.mark.parametrize("row_align", [1, 8])
@pytest.mark.parametrize("which", ["ragged", "mlp"])
def test_flatspec_pack_unpack_bit_equal(which, row_align):
    rng = np.random.default_rng(1)
    make = ((lambda: _ragged_tree(rng)) if which == "ragged"
            else (lambda: _mlp(rng, [32, 64, 64, 10])))
    tree, stacked = make(), [make() for _ in range(3)]
    stack_np = jax.tree.map(lambda *ls: np.stack(ls), *stacked)
    jspec = JFlatSpec.from_tree(tree, row_align=row_align)
    spec = FlatSpec.from_tree(params_from_numpy(tree, "cpu"),
                              row_align=row_align)
    assert (spec.rows, spec.padded, spec.offsets, spec.sizes) == (
        jspec.rows, jspec.padded, jspec.offsets, jspec.sizes)
    assert spec.padded > spec.n_elems or row_align == 1
    buf = spec.pack(params_from_numpy(tree, "cpu"))
    _bits_equal(buf.numpy(), jspec.pack(jax.tree.map(jnp.asarray, tree)))
    sbuf = spec.pack_stacked(params_from_numpy(stack_np, "cpu"))
    _bits_equal(sbuf.numpy(),
                jspec.pack_stacked(jax.tree.map(jnp.asarray, stack_np)))
    _tree_bits_equal(spec.unpack(buf), tree)
    _tree_bits_equal(spec.unpack_stacked(sbuf), stack_np)
    assert float(buf.reshape(-1)[spec.n_elems:].abs().sum()) == 0.0


def test_scalar_lanes_bit_equal():
    rng = np.random.default_rng(4)
    cols = {"interval": rng.random(5).astype(np.float32),
            "last_t": rng.random(5).astype(np.float32)}
    lane = RATE_LANE.pack(cols)                # host numpy in the port
    assert isinstance(lane, np.ndarray)
    jlane = JRATE_LANE.pack({k: jnp.asarray(v) for k, v in cols.items()})
    _bits_equal(lane, jlane)
    for name in cols:
        _bits_equal(RATE_LANE.get(lane, name), JRATE_LANE.get(jlane, name))
        _bits_equal(RATE_LANE.unpack(lane)[name],
                    JRATE_LANE.unpack(jlane)[name])
    _bits_equal(RATE_LANE.set_at(lane, "last_t", 3, 7.5),
                JRATE_LANE.set_at(jlane, "last_t", 3, 7.5))
    one = ScalarLane(("sent_step",))
    _bits_equal(one.init(4, sent_step=2.0),
                JScalarLane(("sent_step",)).init(4, sent_step=2.0))
    with pytest.raises(ValueError):
        ScalarLane(("a", "a"))


# -- schedules and the event model --------------------------------------
@pytest.mark.parametrize("sched", [
    dict(base_lr=0.1),
    dict(base_lr=0.1, num_workers=8, warmup_steps=10),
    dict(base_lr=0.05, num_workers=3, warmup_steps=7, milestones=(9, 20),
         decay_factor=0.3),
])
def test_schedule_and_momentum_correction_bit_equal(sched):
    js, ts = JSchedule(**sched), Schedule(**sched)
    steps = np.arange(30)
    port = np.asarray([ts(int(t)) for t in steps], np.float32)
    _bits_equal(port, np.asarray([js(jnp.int32(t)) for t in steps]))
    _bits_equal(ts(steps), port)                   # vectorised == scalar
    for a, b in zip(port[1:], port[:-1]):
        _bits_equal(momentum_correction(None, a, b),
                    jmc(None, jnp.float32(a), jnp.float32(b)))
    assert momentum_correction(None, np.float32(0.1), np.float32(0)) == 1.0


@pytest.mark.parametrize("hetero", [False, True])
def test_gamma_model_draws_identical(hetero):
    make = "heterogeneous_env" if hetero else "homogeneous"
    jd = getattr(JGamma, make)(batch_size=64, seed=5).sampler(6)
    td = getattr(GammaModel, make)(batch_size=64, seed=5).sampler(6)
    seq = [i % 6 for i in range(50)]
    assert [jd(i) for i in seq] == [td(i) for i in seq]


# -- the thirteen algorithms ----------------------------------------------
ALGOS = [("asgd", {}), ("nag-asgd", {}), ("nag-asgd", {"nesterov": False}),
         ("multi-asgd", {}), ("multi-asgd", {"nesterov": True}),
         ("dana-zero", {}), ("dana-slim", {}), ("sa-asgd", {}),
         ("dc-asgd", {}), ("lwp", {}), ("dana-dc", {}), ("dana-hetero", {}),
         ("nadam-asgd", {}), ("dana-nadam", {}), ("ga-asgd", {})]
# Reductions sum in another order in PyTorch than in JAX: dana-hetero's
# rate-weighted send (an N-way tensordot) and ga-asgd's gap and step
# norms.  Every other member is elementwise and bit-exact.
REDUCING = {"dana-hetero": dict(rtol=1e-6, atol=1e-7),
            "ga-asgd": dict(rtol=2e-6, atol=2e-7)}
TREE_KEYS = ("theta0", "v", "v0", "m", "m0", "u", "sent")
HOST_KEYS = ("lr_prev", "vscale", "tau", "sent_t", "interval", "last_t",
             "avg_step")
SCHEDULES = {"constant": None,
             "warmup+decay": dict(base_lr=0.05, num_workers=3,
                                  warmup_steps=4, milestones=(6,),
                                  decay_factor=0.5)}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("name,kw", ALGOS)
def test_algorithms_bit_equal_to_eager_jax(name, kw, sched):
    rng = np.random.default_rng(2)
    params = _ragged_tree(rng)
    n, order = 3, [0, 2, 1, 0, 0, 2, 1, 2, 1]
    grads = [_ragged_tree(rng, 0.5) for _ in order]
    sc = SCHEDULES[sched]
    jalgo = jalg.make_algorithm(name, JHP(lr=0.05, momentum=0.9),
                                None if sc is None else JSchedule(**sc),
                                **kw)
    talgo = talg.make_algorithm(name, HyperParams(lr=0.05, momentum=0.9),
                                None if sc is None else Schedule(**sc),
                                **kw)
    tol = REDUCING.get(name)

    def same(a, b):
        if tol is None:
            _tree_bits_equal(a, b)
        else:
            for x, y in zip(tree_leaves(a), jax.tree.leaves(b)):
                np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                           **tol)

    with jax.disable_jit():
        js = jalgo.init(jax.tree.map(jnp.asarray, params), n)
        ts = talgo.init(params_from_numpy(params, "cpu"), n)
        for step, (i, g) in enumerate(zip(order, grads)):
            now = 0.75 * (step + 1) + 0.1 * i   # message time (dana-hetero)
            js = jalgo.receive(js, jnp.int32(i), jax.tree.map(jnp.asarray, g),
                               jnp.float32(now))
            ts = talgo.receive(ts, i, params_from_numpy(g, "cpu"), now)
            jv, js = jalgo.send(js, jnp.int32(i))
            tv, ts = talgo.send(ts, i)
            same(tv, jv)
            assert ts["t"] == int(js["t"])
            for key in TREE_KEYS:
                if key in js:
                    same(ts[key], js[key])
            for key in HOST_KEYS:
                if key in js:
                    same(ts[key], js[key])
        same(talgo.master_params(ts), jalgo.master_params(js))
    assert set(ts) == set(js)


def test_unported_algorithm_names_raise():
    """Every name of the JAX package's registry builds (the four
    off-flat members since they were ported); only unknown names
    raise."""
    for name in ("ssgd", "easgd", "dana-easgd", "yellowfin"):
        assert talg.make_algorithm(name).name == name
    with pytest.raises(ValueError, match="unknown algorithm"):
        talg.make_algorithm("no-such-thing")
    assert sorted(talg.REGISTRY) == sorted(jalg.REGISTRY)
    assert len(talg.REGISTRY) == 17


def test_tree_set_index_writes_in_place_and_index_is_a_view():
    v = {"a": torch.zeros(3, 2)}
    row = tree_map(lambda l: l[1], v)
    old = tree_index(v, 1)
    out = tree_set_index(v, 1, {"a": torch.ones(2)})
    assert out is v and float(v["a"][1].sum()) == 2.0
    assert float(old["a"].sum()) == 2.0 and float(row["a"].sum()) == 2.0


def test_tree_utilities_free_their_results_without_the_cyclic_gc():
    """A tree built by the utilities dies with its last reference: no
    reference cycle keeps its leaves (the master's reply views, the
    workers' gradients) alive until a garbage collection."""
    import gc
    import weakref
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        x = {"a": torch.zeros(1000), "b": [torch.zeros(10), None]}
        y = tree_map(lambda t: t + 1, x)
        leaves, treedef = tree_flatten(y)
        z = tree_unflatten(treedef, [t * 2 for t in leaves])
        refs = [weakref.ref(t) for t in tree_leaves(y) + tree_leaves(z)]
        del y, z, leaves
        assert all(r() is None for r in refs)
    finally:
        if was_enabled:
            gc.enable()
