"""The port's gap-aware master update (ga-asgd) against the JAX package's.

The plain version (the gap branch of ``ref.py``) is what CPU tensors run
and what the CUDA kernel ``gap_update`` is held against on the card.
Here it is held against

* the eager JAX reference (``jax.disable_jit()``), and
* the JAX package's two-phase Pallas kernel
  ``flat_master_update_batch_gap`` run as the JAX package's own tests
  run it on the CPU (``interpret=True``, R=512 so the grid sweeps two
  row tiles, N=3, k in {1, 4} with duplicate ids),

to rtol=2e-6, atol=2e-7, the tolerance the JAX package holds its own
kernel to (``tests/test_flat_update.py::test_gap_pallas_matches_ref``):
the gap and step norms are sums over every element, and ``torch.sum``,
``jnp.sum`` and the Pallas tiles add in different orders.  Everything
else in the update is elementwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flat_update.kernel import flat_master_update_batch_gap
from repro.kernels.flat_update.ref import (
    flat_master_update_batch_ref as jref)

from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.flat_update import flat_master_update_batch
from repro_torch.kernels.flat_update.kernel import flat_update_batch_gap
from repro_torch.kernels.flat_update.ref import flat_master_update_batch_ref

torch.set_num_threads(1)

TOL = dict(rtol=2e-6, atol=2e-7)
EMA = 0.99


def _inputs(r, n, k, seed, *, n_elems=None, avg=1e-3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    theta = f(r, 128)
    ins = {"theta": theta, "v": f(n, r, 128) * 0.1,
           "sent": theta + 0.01 * f(n, r, 128), "g": f(k, r, 128),
           "avg": np.float32(avg)}
    if n_elems is not None:            # zero padding tail, as FlatSpec packs
        for key in ("theta", "v", "sent", "g"):
            flat = ins[key].reshape(-1, r * 128)
            flat[:, n_elems:] = 0.0
    scal = {"lrs": np.linspace(0.05, 0.04, k).astype(np.float32),
            "gammas": np.full(k, 0.9, np.float32),
            "cgs": np.ones(k, np.float32),
            "vscales": np.linspace(1.0, 0.9, k).astype(np.float32)}
    return ins, scal


def _port(ins, scal, ids, n_elems, telemetry=True):
    T = lambda a: torch.from_numpy(np.array(a, copy=True))
    return flat_master_update_batch_ref(
        T(ins["theta"]), T(ins["v"]), None, None, T(ins["sent"]),
        torch.tensor(ins["avg"]), T(ins["g"]), ids, scal["lrs"], None,
        scal["gammas"], scal["cgs"], scal["vscales"], nesterov=False,
        gap_aware=True, gap_ema=EMA, n_elems=n_elems, hat_mode="theta",
        telemetry=telemetry)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL,
                               err_msg=what)


@pytest.mark.parametrize("k", [1, 4])
def test_plain_gap_update_matches_eager_jax_reference(k):
    r, n = 24, 3
    n_elems = r * 128 - 77                  # padding must not dilute G
    ins, scal = _inputs(r, n, k, seed=k, n_elems=n_elems)
    ids = np.asarray([0, 2, 0, 1][:k])
    port = _port(ins, scal, ids, n_elems)
    J = jnp.asarray
    with jax.disable_jit():
        ref = jref(J(ins["theta"]), J(ins["v"]), None, None, J(ins["sent"]),
                   J(ins["avg"]), J(ins["g"]), J(ids, jnp.int32),
                   J(scal["lrs"]), J(scal["lrs"]), J(scal["gammas"]),
                   J(scal["cgs"]), J(scal["vscales"]), nesterov=False,
                   gap_aware=True, gap_ema=EMA, n_elems=n_elems,
                   hat_mode="theta", telemetry=True)
    names = ("theta", "v", "v0", "u2", "sent", "avg_step", "hats", "pres")
    for name, a, b in zip(names, port, ref):
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if name == "hats":
            a = torch.stack(a)
        _close(a, b, name)


@pytest.mark.parametrize("k", [1, 4])
def test_plain_gap_update_matches_pallas_interpret(k):
    r, n = 512, 3                     # two row tiles: the grid really sweeps
    ins, scal = _inputs(r, n, k, seed=10 + k)
    ids = np.asarray([0, 2, 0, 1][:k])
    port = _port(ins, scal, ids, r * 128)
    J = jnp.asarray
    outk = flat_master_update_batch_gap(
        J(ins["theta"]), J(ins["v"]), J(ins["sent"]), J(ins["avg"]),
        J(ins["g"]), J(ids, jnp.int32), J(scal["lrs"]), J(scal["gammas"]),
        J(scal["cgs"]), J(scal["vscales"]), gap_ema=EMA, n_elems=r * 128,
        telemetry=True, interpret=True)
    pairs = [("theta", port[0], outk[0]), ("v", port[1], outk[1]),
             ("sent", port[4], outk[2]), ("avg_step", port[5], outk[3]),
             ("hats", torch.stack(port[6]), outk[4]),
             ("pres", port[7], outk[5])]
    for name, a, b in pairs:
        _close(a, b, name)


def test_first_message_of_a_run_is_unpenalised():
    """At the start of a run every snapshot equals theta: the gap is 0,
    the penalty exactly 1, and the first message of each worker is the
    plain heavy-ball update bit for bit, however small avg_step is (a
    gap that were slightly off would make a huge penalty here)."""
    r, n = 16, 2
    ins, scal = _inputs(r, n, 1, seed=5, avg=1e-8)
    ins["sent"] = np.broadcast_to(ins["theta"], (n, r, 128)).copy()
    gap = _port(ins, scal, [1], r * 128, telemetry=False)
    T = lambda a: torch.from_numpy(np.array(a, copy=True))
    plain = flat_master_update_batch_ref(
        T(ins["theta"]), T(ins["v"]), None, None, None, None, T(ins["g"]),
        [1], scal["lrs"], None, scal["gammas"], scal["cgs"],
        scal["vscales"], nesterov=False, hat_mode="theta")
    for a, b in ((gap[0], plain[0]), (gap[1], plain[1]),
                 (gap[6][0], plain[6][0]), (gap[4][1], plain[0])):
        assert torch.equal(a, b)
    assert torch.equal(gap[4][0], T(ins["theta"]))   # worker 0 untouched
    assert float(gap[5]) > 1e-8                      # avg_step moved


def test_plain_gap_update_is_in_place():
    ins, scal = _inputs(8, 2, 2, seed=7)
    T = lambda a: torch.from_numpy(np.array(a, copy=True))
    theta, v, sent = T(ins["theta"]), T(ins["v"]), T(ins["sent"])
    avg = torch.tensor(ins["avg"])
    out = flat_master_update_batch_ref(
        theta, v, None, None, sent, avg, T(ins["g"]), [1, 1], scal["lrs"],
        None, scal["gammas"], scal["cgs"], scal["vscales"], nesterov=False,
        gap_aware=True, gap_ema=EMA, n_elems=8 * 128, hat_mode="theta")
    assert out[0] is theta and out[1] is v and out[4] is sent
    assert out[5] is avg and float(avg) != float(ins["avg"])
    assert torch.equal(sent[1], theta)        # the snapshot is theta'


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    ins, scal = _inputs(8, 3, 3, seed=8)
    ids = [2, 0, 2]
    ref = _port(ins, scal, ids, 8 * 128)
    T = lambda a: torch.from_numpy(np.array(a, copy=True))
    avg = torch.tensor(ins["avg"])
    reset_launches()
    out = flat_master_update_batch(
        T(ins["theta"]), T(ins["v"]), None, None, T(ins["sent"]),
        T(ins["g"]), ids, scal["lrs"], scal["gammas"], scal["cgs"],
        scal["vscales"], None, nesterov=False, hat_mode="theta",
        telemetry=True, avg_step=avg, gap_aware=True, gap_ema=EMA,
        n_elems=8 * 128)
    for a, b in ((out[0], ref[0]), (out[1], ref[1]), (out[4], ref[4]),
                 (avg, ref[5]), (out[6], ref[7])):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out[5], ref[6]))
    assert out[2] is None and out[3] is None
    assert launches()["gap_update"] == 0
    # the CUDA wrapper refuses CPU tensors: no fallback
    with pytest.raises(ValueError, match="CUDA"):
        flat_update_batch_gap(
            T(ins["theta"]), T(ins["v"]), T(ins["sent"]), avg, T(ins["g"]),
            ids, scal["lrs"], scal["gammas"], scal["cgs"], scal["vscales"],
            gap_ema=EMA, n_elems=8 * 128)
    # the gap-aware update is ga-asgd's rule only
    with pytest.raises(ValueError, match="gap-aware"):
        flat_master_update_batch(
            T(ins["theta"]), T(ins["v"]), T(ins["theta"]), None,
            T(ins["sent"]), T(ins["g"]), ids, scal["lrs"], scal["gammas"],
            scal["cgs"], scal["vscales"], None, nesterov=False,
            hat_mode="theta", avg_step=avg, gap_aware=True, n_elems=1024)
    assert launches()["gap_update"] == 0
