"""The port's discrete-event engine against the JAX package's, on the CPU.

Both engines start from the same numpy ``params0`` and draw the same
events and batches from the same numpy streams, so the event stream
(time, worker, lag, step) must be EQUAL.  The numbers (gap, gradient
norm, eval loss, final parameters) agree to rtol=1e-5, atol=1e-6: the
JAX engine jits its whole step (XLA contracts FMAs and its CPU matrix
products sum in another order than PyTorch's), and the difference
compounds over the run.

The jitted JAX flat path can itself leave the JAX tree path when a
one-ULP FMA difference flips a ReLU: from ``params0`` seed 0 at lr=0.05
its dana-zero run ends far outside f32 tolerance of its own tree run
(the JAX package's ``test_engine_flat_execution_matches_tree`` fails
for that reason), while the port's flat and tree runs agree exactly and
stay within tolerance of the JAX tree run
(``test_port_flat_path_tracks_jax_tree_path``).  The other comparisons
start from seed 1, where the JAX package's two paths agree, so they
measure the port and not that flip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms import make_algorithm as jmake
from repro.core.engine import SimulationConfig as JConfig
from repro.core.engine import run_simulation as jrun
from repro.core.schedules import Schedule as JSchedule
from repro.core.types import HyperParams as JHP
from repro.data.synthetic import ClassificationTask as JTask
from repro.kernels.flat_update import FlatAlgorithm as JFlat
from repro.models.toy import make_classifier_fns as jfns

from repro_torch.convert import flat_state_from_numpy, params_from_numpy
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.engine import SimulationConfig, run_simulation
from repro_torch.core.schedules import Schedule
from repro_torch.core.types import HyperParams, tree_leaves
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.kernels.flat_update import (FlatAlgorithm, launches,
                                             reset_launches)
from repro_torch.models.toy import make_classifier_fns

# These checks run on tiny tensors, where extra intra-op threads only
# spin; one thread keeps them from taking cores from the timed
# benchmark smoke that runs beside them under pytest-xdist.
torch.set_num_threads(1)

DIMS = [32, 64, 64, 10]
TOL = dict(rtol=1e-5, atol=1e-6)


def _params0(seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(DIMS[:-1], DIMS[1:])]


def _both(name, use_kernel, schedule=None, *, seed=1, jax_kernel=None,
          lr=0.05):
    p0 = _params0(seed)
    hp = dict(lr=lr, momentum=0.9)
    kw = dict(num_workers=4, total_grads=60, eval_every=20,
              use_kernel=use_kernel)
    jkw = dict(kw, use_kernel=use_kernel if jax_kernel is None
               else jax_kernel)
    jtask = JTask(dim=32, batch_size=16)
    _, jgrad, jmk = jfns(DIMS)
    jh = jrun(jmake(name, JHP(**hp),
                    None if schedule is None else JSchedule(**schedule)),
              jgrad, jax.tree.map(jnp.asarray, p0), jtask.batch,
              JConfig(**jkw), jmk(jtask.eval_batch()))
    task = ClassificationTask(dim=32, batch_size=16, device="cpu")
    _, grad, mk = make_classifier_fns(DIMS)
    th = run_simulation(make_algorithm(
        name, HyperParams(**hp),
        None if schedule is None else Schedule(**schedule)),
        grad, params_from_numpy(p0, "cpu"), task.batch,
        SimulationConfig(device="cpu", **kw), mk(task.eval_batch()))
    return jh, th


CASES = [("dana-zero", None), ("nag-asgd", None), ("dana-slim", None),
         ("dana-zero", dict(base_lr=0.05, num_workers=4, warmup_steps=20,
                            milestones=(45,), decay_factor=0.5))]
# the members beyond the first five, on both paths (ga-asgd's flat path
# runs the plain gap-aware update here)
NEW_MEMBERS = ["sa-asgd", "dc-asgd", "lwp", "dana-dc", "dana-hetero",
               "nadam-asgd", "dana-nadam", "ga-asgd"]
SENT_FAMILY = ("dc-asgd", "dana-dc", "ga-asgd")
# The Nadam pair takes an Adam-sized rate: at lr=0.05 every element moves
# by about lr per step whatever its gradient, the loss diverges (gradient
# norms grow 60-fold in 60 steps), and the JAX engine's jitted FMAs,
# amplified by that growth, leave f32 tolerance of any eager computation
# (both members equal the eager JAX package bit for bit:
# test_torch_core.py, test_torch_flat_update.py).
LR = {"nadam-asgd": 0.005, "dana-nadam": 0.005}


def _assert_match(jh, th):
    for key in ("time", "worker", "lag", "step", "eval_step"):
        assert getattr(th, key) == getattr(jh, key), key
    # the sent-snapshot staleness column: the lag for the snapshot
    # members, NaN for the rest, in both engines
    np.testing.assert_array_equal(th.staleness, jh.staleness)
    assert len(th.gap) == 60 and len(th.eval_loss) == 3
    for key in ("gap", "grad_norm", "eval_loss", "eval_metric"):
        np.testing.assert_allclose(getattr(th, key), getattr(jh, key),
                                   **TOL, err_msg=key)
    fp = tree_leaves(th.final_params)
    jfp = jax.tree.leaves(jh.final_params)
    assert [tuple(a.shape) for a in fp] == [a.shape for a in jfp]
    for a, b in zip(fp, jfp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert all(np.isfinite(th.eval_loss))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name,schedule", CASES)
def test_engine_matches_jax_engine(name, schedule, use_kernel):
    _assert_match(*_both(name, use_kernel, schedule))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", NEW_MEMBERS)
def test_new_members_match_jax_engine(name, use_kernel):
    jh, th = _both(name, use_kernel, lr=LR.get(name, 0.05))
    _assert_match(jh, th)
    if name in SENT_FAMILY:
        assert th.staleness == [float(l) for l in th.lag]
    else:
        assert np.isnan(th.staleness).all()


def test_port_flat_path_tracks_jax_tree_path():
    """From seed 0 (where the JAX flat path drifts off its tree path) the
    port's flat path still matches the JAX tree path."""
    _assert_match(*_both("dana-zero", True, seed=0, jax_kernel=False))


def test_flat_and_tree_paths_of_the_port_agree_on_cpu():
    """The flat path (plain batched update) and the tree algorithm are
    one computation: the port's two engine runs agree bit for bit and
    launch no kernel on the CPU."""
    p0 = _params0(1)
    task = ClassificationTask(dim=32, batch_size=16, device="cpu")
    _, grad, mk = make_classifier_fns(DIMS)
    reset_launches()
    hists = []
    for use_kernel in (True, False):
        hists.append(run_simulation(
            make_algorithm("dana-zero", HyperParams(lr=0.05)), grad,
            params_from_numpy(p0, "cpu"), task.batch,
            SimulationConfig(num_workers=4, total_grads=40, eval_every=10,
                             use_kernel=use_kernel, device="cpu"),
            mk(task.eval_batch())))
    assert hists[0].gap == hists[1].gap
    assert hists[0].eval_loss == hists[1].eval_loss
    for a, b in zip(tree_leaves(hists[0].final_params),
                    tree_leaves(hists[1].final_params)):
        assert torch.equal(a, b)
    assert launches() == {"flat_update_batch": 0, "send_view": 0}


@pytest.mark.parametrize("name", ["asgd", "nag-asgd", "multi-asgd",
                                  "dana-zero", "dana-slim"] + NEW_MEMBERS)
def test_converted_jax_flat_state_equals_port_init(name):
    p0 = _params0(2)
    jfa = JFlat(jmake(name, JHP(lr=0.03)), use_pallas=False)
    js = jfa.init(jax.tree.map(jnp.asarray, p0), 5)
    tfa = FlatAlgorithm(make_algorithm(name, HyperParams(lr=0.03)))
    ts = tfa.init(params_from_numpy(p0, "cpu"), 5)
    conv = flat_state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                                 "cpu")
    assert set(conv) == set(ts)
    for key, val in ts.items():
        if isinstance(val, torch.Tensor):
            assert val.dtype == conv[key].dtype
            assert torch.equal(conv[key], val), key
        elif isinstance(val, np.ndarray):          # a host scalar lane
            assert conv[key].dtype == val.dtype == np.float32
            np.testing.assert_array_equal(conv[key], val, err_msg=key)
        else:
            assert conv[key] == val and type(conv[key]) is type(val), key
    assert (tfa.spec.rows, tfa.spec.n_elems) == (jfa.spec.rows,
                                                jfa.spec.n_elems)


def test_ssgd_raises_until_ported():
    """ssgd runs on the synchronous barrier (``_run_ssgd``); asked for
    the per-message flat path it raises the JAX package's ValueError."""
    from repro_torch.core.algorithms import make_algorithm
    with pytest.raises(ValueError, match="ssgd is not kernel-eligible"):
        run_simulation(make_algorithm("ssgd"), None, [], None,
                       SimulationConfig(device="cpu", use_kernel=True))
