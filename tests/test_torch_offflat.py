"""The four off-flat algorithms (ssgd, easgd, dana-easgd, yellowfin)
against the JAX package, on the CPU.

* One receive of each against the JAX package's under
  ``jax.disable_jit()``, on states and gradients made from numpy: ssgd's
  ``receive_all`` and easgd bit for bit (elementwise, each a*b+c rounded
  twice as the eager JAX expression); dana-easgd (a sum over the N
  momenta) and yellowfin (gradient norms) at rtol 1e-6 / atol 1e-7, the
  sums' order being torch's, not XLA's.
* ``run_simulation`` with each, from ``params0`` seed 1 at lr 0.01
  (ROADMAP.md C13), against the jitted JAX engine: event streams exact,
  final parameters within rtol 1e-5; for ssgd the round count and the
  telemetry rows exact.
* The JAX package's algebraic checks (``tests/test_extensions.py``) on
  ``quadratic_fns``, the port's and the JAX package's with the same
  matrix.
* The deterministic cluster (tree path) bit for bit the port's engine;
  ssgd refused by ``run_cluster`` with the JAX package's message; the
  cluster CLI with ``--algo easgd``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms import make_algorithm as jmake
from repro.core.engine import SimulationConfig as JConfig
from repro.core.engine import run_simulation as jrun
from repro.core.types import HyperParams as JHP
from repro.data.synthetic import ClassificationTask as JTask
from repro.models.toy import make_classifier_fns as jfns
from repro.models.toy import quadratic_fns as jquadratic

from repro_torch.cluster import ClusterConfig, run_cluster
from repro_torch.convert import params_from_numpy
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.engine import SimulationConfig, run_simulation
from repro_torch.core.gamma import GammaModel
from repro_torch.core.types import HyperParams, tree_leaves, tree_map
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models.toy import make_classifier_fns, quadratic_fns

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OFF_FLAT = ("ssgd", "easgd", "dana-easgd", "yellowfin")
BITWISE = ("ssgd", "easgd")
SUM_TOL = dict(rtol=1e-6, atol=1e-7)
ENGINE_TOL = dict(rtol=1e-5, atol=1e-6)
DIMS = [32, 64, 64, 10]


def _params0(seed=1, dims=DIMS):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _compare(ts, js, tol):
    """Every key of the two states: tensors/trees elementwise, the step
    exactly."""
    assert set(ts) == set(js)
    for key in js:
        tl = tree_leaves(ts[key]) if not np.isscalar(ts[key]) else [ts[key]]
        jl = jax.tree.leaves(js[key])
        assert len(tl) == len(jl), key
        for a, b in zip(tl, jl):
            a, b = _np(a), np.asarray(b)
            if key == "t":
                assert int(a) == int(b)
            elif tol is None:
                np.testing.assert_array_equal(a.astype(np.float32),
                                              b.astype(np.float32),
                                              err_msg=key)
            else:
                np.testing.assert_allclose(a, b, err_msg=key, **tol)


@pytest.mark.parametrize("name", OFF_FLAT)
def test_one_receive_matches_the_eager_jax_package(name):
    """Four receives (worker order 0, 2, 1, 0 of N=3) and the sends
    between them, on the same numpy parameters and gradients."""
    rng = np.random.default_rng(7)
    p0 = _params0(2, [8, 16, 4])
    grads = [tree_map(lambda l: (rng.standard_normal(l.shape) * 0.3)
                      .astype(np.float32), p0) for _ in range(4)]
    hp = dict(lr=0.05, momentum=0.9)
    talgo, jalgo = make_algorithm(name, HyperParams(**hp)), jmake(
        name, JHP(**hp))
    with jax.disable_jit():
        ts = talgo.init(params_from_numpy(p0, "cpu"), 3)
        js = jalgo.init(jax.tree.map(jnp.asarray, p0), 3)
        for i in range(3):
            tv, ts = talgo.send(ts, i)
            jv, js = jalgo.send(js, i)
            _compare({"v": tv}, {"v": jv}, None)
        for i, g in zip([0, 2, 1, 0], grads):
            tg = params_from_numpy(g, "cpu")
            jg = jax.tree.map(jnp.asarray, g)
            if name == "ssgd":
                ts = talgo.receive_all(ts, tg)
                js = jalgo.receive_all(js, jg)
            else:
                ts = talgo.receive(ts, i, tg)
                js = jalgo.receive(js, i, jg)
            tv, ts = talgo.send(ts, i)
            jv, js = jalgo.send(js, i)
            tol = None if name in BITWISE else SUM_TOL
            _compare({"v": tv}, {"v": jv}, tol)
            _compare(ts, js, tol)
    if name == "yellowfin":
        # the tuner's scalars stay 0-d tensors (no host sync a message)
        for key in ("h_min", "h_max", "g2_ema", "g_norm_ema", "dist_ema",
                    "mu", "lr_yf"):
            assert isinstance(ts[key], torch.Tensor) and ts[key].dim() == 0
        assert isinstance(ts["lr_prev"], np.float32)


def _runs(name, grads=60, workers=4):
    hp = dict(lr=0.01, momentum=0.9)
    p0 = _params0(1)
    kw = dict(num_workers=workers, total_grads=grads, eval_every=20)
    jtask = JTask(dim=32, batch_size=16)
    _, jgrad, jmk = jfns(DIMS)
    jh = jrun(jmake(name, JHP(**hp)), jgrad,
              jax.tree.map(jnp.asarray, p0), jtask.batch, JConfig(**kw),
              jmk(jtask.eval_batch()))
    task = ClassificationTask(dim=32, batch_size=16, device="cpu")
    _, grad, mk = make_classifier_fns(DIMS)
    th = run_simulation(make_algorithm(name, HyperParams(**hp)), grad,
                        params_from_numpy(p0, "cpu"), task.batch,
                        SimulationConfig(device="cpu", **kw),
                        mk(task.eval_batch()))
    return jh, th


@pytest.mark.parametrize("name", OFF_FLAT)
def test_run_simulation_matches_the_jax_engine(name):
    jh, th = _runs(name)
    for key in ("time", "worker", "lag", "step", "eval_step", "eval_time"):
        assert getattr(th, key) == getattr(jh, key), key
    np.testing.assert_array_equal(th.staleness, jh.staleness)
    np.testing.assert_allclose(th.grad_norm, jh.grad_norm, **ENGINE_TOL)
    np.testing.assert_allclose(th.eval_loss, jh.eval_loss, **ENGINE_TOL)
    for a, b in zip(tree_leaves(th.final_params),
                    jax.tree.leaves(jh.final_params)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **ENGINE_TOL)
    if name == "ssgd":
        # 60 gradients of 4 workers: 15 barrier rounds, one row each
        assert len(th.step) == 15 and th.step == list(range(1, 16))
        assert set(th.worker) == {-1} and set(th.lag) == {0}
        assert th.gap == jh.gap == [0.0] * 15
    else:
        assert len(th.step) == 60


def test_ssgd_barrier_costs_time():
    """App. C: for the same gradients the barrier waits for the slowest
    worker every round (the JAX package's ``test_engine.py`` check)."""
    task = ClassificationTask(dim=32, batch_size=16, device="cpu")
    _, grad, _ = make_classifier_fns(DIMS)

    def sim(name):
        return run_simulation(
            make_algorithm(name, HyperParams(lr=0.01)), grad,
            params_from_numpy(_params0(1), "cpu"), task.batch,
            SimulationConfig(num_workers=8, total_grads=160,
                             exec_model=GammaModel.heterogeneous_env(
                                 seed=0), device="cpu"))
    assert sim("ssgd").time[-1] > 1.2 * sim("dana-slim").time[-1]


# ---------------------------------------------------------------------------
# the algebra on the quadratic (tests/test_extensions.py's checks)
# ---------------------------------------------------------------------------
def _drive(algo, params0, grad_fn, order):
    n = max(order) + 1
    state = algo.init(params0, n)
    views = {}
    for i in range(n):
        views[i], state = algo.send(state, i)
    for i in order:
        state = algo.receive(state, i, grad_fn(views[i], None))
        views[i], state = algo.send(state, i)
    return state


def _quadratic(dim, cond):
    """The port's quadratic on the JAX package's matrix, and the JAX
    package's functions."""
    jp0, jloss, jgrad = jquadratic(dim=dim, cond=cond)
    h = np.asarray(jax.jit(jax.hessian(jloss))(jp0)["x"]["x"])
    return quadratic_fns(dim=dim, cond=cond, h=h, device="cpu"), (
        jp0, jloss, jgrad)


def test_quadratic_fns_matches_the_jax_package():
    (p0, loss, grad), (jp0, jloss, jgrad) = _quadratic(16, 8.0)
    np.testing.assert_array_equal(_np(p0["x"]), np.asarray(jp0["x"]))
    x = np.random.default_rng(0).standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(float(loss({"x": torch.from_numpy(x)})),
                               float(jloss({"x": jnp.asarray(x)})),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(grad({"x": torch.from_numpy(x)})["x"]),
                               np.asarray(jgrad({"x": jnp.asarray(x)})["x"]),
                               rtol=1e-5, atol=1e-5)
    # without a matrix the port draws its own basis from numpy
    p1, loss1, _ = quadratic_fns(dim=16, cond=8.0, device="cpu")
    assert float(loss1(p1)) > 0.0


def test_easgd_center_converges():
    (p0, loss, grad), _ = _quadratic(16, 8.0)
    state = _drive(make_algorithm("easgd", HyperParams(lr=0.05)), p0, grad,
                   [0, 1, 2, 3] * 25)
    assert float(loss(state["theta0"])) < float(loss(p0))


def test_dana_easgd_reduces_to_easgd_without_momentum():
    (p0, loss, grad), _ = _quadratic(10, 8.0)
    order = [0, 1, 0, 1, 1, 0]
    hp0 = HyperParams(lr=0.05, momentum=0.0)
    se = _drive(make_algorithm("easgd", hp0), p0, grad, order)
    sd = _drive(make_algorithm("dana-easgd", hp0), p0, grad, order)
    assert torch.equal(se["theta0"]["x"], sd["theta0"]["x"])


def test_dana_easgd_tracks_center_better():
    (p0, loss, grad), _ = _quadratic(20, 30.0)
    hp = HyperParams(lr=0.1, momentum=0.9)
    order = [0, 1, 2, 3] * 25
    se = _drive(make_algorithm("easgd", hp), p0, grad, order)
    sd = _drive(make_algorithm("dana-easgd", hp), p0, grad, order)
    assert float(loss(sd["theta0"])) <= float(loss(se["theta0"])) * 1.5


def test_yellowfin_and_ssgd_reduce_the_loss():
    (p0, loss, grad), _ = _quadratic(16, 8.0)
    s = _drive(make_algorithm("yellowfin", HyperParams(lr=0.05)), p0, grad,
               [0, 1] * 20)
    assert float(loss(s["theta0"])) < 0.5 * float(loss(p0))
    assert 0.0 <= float(s["mu"]) <= 0.99
    ssgd = make_algorithm("ssgd", HyperParams(lr=0.05, momentum=0.9))
    st = ssgd.init(p0, 2)
    for _ in range(20):
        st = ssgd.receive_all(st, grad(ssgd.master_params(st)))
    assert float(loss(st["theta0"])) < 0.5 * float(loss(p0))


def test_easgd_send_hands_out_a_copy():
    """A view handed out survives the next receive (the replica stack is
    written in place)."""
    (p0, _, grad), _ = _quadratic(8, 4.0)
    algo = make_algorithm("easgd", HyperParams(lr=0.05))
    st = algo.init(p0, 2)
    view, st = algo.send(st, 0)
    before = view["x"].clone()
    st = algo.receive(st, 0, grad(view))
    assert torch.equal(view["x"], before)
    assert not torch.equal(st["x"]["x"][0], before)


# ---------------------------------------------------------------------------
# the cluster
# ---------------------------------------------------------------------------
CDIMS = [8, 16, 4]
TASK = ClassificationTask(dim=8, num_classes=4, batch_size=8, seed=3,
                          device="cpu")
_, CGRAD, CMAKE_EVAL = make_classifier_fns(CDIMS)
CEVAL = CMAKE_EVAL(TASK.eval_batch(32))


@pytest.mark.parametrize("name", ["easgd", "dana-easgd", "yellowfin"])
def test_deterministic_cluster_matches_engine_bit_for_bit(name):
    hp = HyperParams(lr=0.05, momentum=0.9)
    kw = dict(num_workers=4, total_grads=60, eval_every=20,
              exec_model=GammaModel(seed=5), device="cpu")
    h_c = run_cluster(make_algorithm(name, hp), CGRAD,
                      _params0(1, CDIMS), TASK.batch,
                      ClusterConfig(rpc_timeout=20.0, **kw), CEVAL)
    h_e = run_simulation(make_algorithm(name, hp), CGRAD,
                         _params0(1, CDIMS), TASK.batch,
                         SimulationConfig(**kw), CEVAL)
    for key in ("time", "worker", "lag", "step", "gap", "grad_norm",
                "eval_step", "eval_loss"):
        assert getattr(h_c, key) == getattr(h_e, key), key
    for a, b in zip(tree_leaves(h_c.final_params),
                    tree_leaves(h_e.final_params)):
        assert torch.equal(a, b)


def test_free_cluster_runs_the_tree_path():
    stats = {}
    run_cluster(make_algorithm("dana-easgd", HyperParams(lr=0.05)), CGRAD,
                _params0(1, CDIMS), TASK.batch,
                ClusterConfig(num_workers=4, total_grads=60, mode="free",
                              coalesce=4, rpc_timeout=20.0, device="cpu"),
                stats_out=stats)
    assert stats["applied"] == 60 and not stats["flat"]
    with pytest.raises(ValueError, match="flat path|eligible"):
        run_cluster(make_algorithm("easgd"), CGRAD, _params0(1, CDIMS),
                    TASK.batch, ClusterConfig(num_workers=2, total_grads=4,
                                              mode="free", use_kernel=True,
                                              device="cpu"))


def test_ssgd_refused_by_the_cluster():
    with pytest.raises(ValueError, match="synchronous barrier"):
        run_cluster(make_algorithm("ssgd"), CGRAD, _params0(1, CDIMS),
                    TASK.batch, ClusterConfig(num_workers=2, total_grads=4,
                                              device="cpu"))


def test_cluster_cli_runs_easgd():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--device",
         "cpu", "--algo", "easgd", "--mode", "deterministic",
         "--compare-engine", "--workers", "3", "--grads", "30", "--dim",
         "8", "--width", "16", "--batch", "8", "--eval-every", "10"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "BIT-EXACT" in proc.stdout
