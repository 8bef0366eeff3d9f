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

from repro_torch.core.types import sqrt_rn
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


# ids of each batch: one message; four with a repeat apart; four with
# adjacent repeats (worker 1 twice in a row: the second message's gap is
# exactly 0)
IDS = {"1": [0], "4": [0, 2, 0, 1], "4-adjacent": [1, 1, 0, 1]}


@pytest.mark.parametrize("case", IDS)
def test_plain_gap_update_matches_eager_jax_reference(case):
    ids = np.asarray(IDS[case])
    k = len(ids)
    r, n = 24, 3
    n_elems = r * 128 - 77                  # padding must not dilute G
    ins, scal = _inputs(r, n, k, seed=k + 2 * case.endswith("adjacent"),
                        n_elems=n_elems)
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


@pytest.mark.parametrize("case", IDS)
def test_plain_gap_update_matches_pallas_interpret(case):
    ids = np.asarray(IDS[case])
    k = len(ids)
    r, n = 512, 3                     # two row tiles: the grid really sweeps
    ins, scal = _inputs(r, n, k, seed=10 + k + 2 * case.endswith("adjacent"))
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


# ---------------------------------------------------------------------------
# A model of the CUDA kernels' launch order (csrc/gap_update.cu), run here
# where there is no card: the same per-thread grid-stride sums, warp and
# block trees and fixed-order partial sums, the next message's norm taken
# in the pass that writes theta', and avg_step kept in ping-pong slots.
# ---------------------------------------------------------------------------
THREADS, MAX_BLOCKS = 256, 1024          # kThreads, kMaxBlocks


def _tree32(x):
    """A warp's shuffle-down tree over its last axis of 32 lanes: lane 0's
    value."""
    x = x.clone()
    for o in (16, 8, 4, 2, 1):
        x[..., :o] = x[..., :o] + x[..., o:2 * o]
    return x[..., 0]


def _block_sum(x):
    """block_sum over (..., 256) per-thread values: each warp's tree, then
    warp 0's tree over the 8 warp sums (its other lanes 0)."""
    warps = _tree32(x.reshape(*x.shape[:-1], THREADS // 32, 32))
    lanes = torch.zeros(*x.shape[:-1], 32)
    lanes[..., :THREADS // 32] = warps
    return _tree32(lanes)


def _partials(terms4, nblocks):
    """The G block partials of per-float4 terms (e4, 4): each thread adds
    its float4s' four terms in a grid-stride loop, then block_sum."""
    t = nblocks * THREADS
    acc = torch.zeros(t)
    for lo in range(0, terms4.shape[0], t):
        chunk = terms4[lo:lo + t]
        for c in range(4):
            acc[:chunk.shape[0]] = acc[:chunk.shape[0]] + chunk[:, c]
    return _block_sum(acc.reshape(nblocks, THREADS))


def _sum_partials(partial):
    """sum_partials: thread t adds partial[t], partial[t + 256], ... in
    order, then block_sum."""
    acc = torch.zeros(THREADS)
    for lo in range(0, partial.shape[0], THREADS):
        chunk = partial[lo:lo + THREADS]
        acc[:chunk.shape[0]] = acc[:chunk.shape[0]] + chunk
    return _block_sum(acc)


def _kernel_model(ins, scal, ids, n_elems, *, fused):
    """theta, v, sent, avg_step, hats, pres as the k + 2 launches compute
    them (``fused``), or as the earlier two-pass order did (3k launches:
    each message's norm read back from memory, avg_step finished at once
    after each message)."""
    T = lambda a: torch.from_numpy(np.array(a, copy=True))
    theta, v, sent = T(ins["theta"]), T(ins["v"]), T(ins["sent"])
    g = T(ins["g"])
    r, k = theta.shape[0], len(ids)
    e4 = r * 32
    nblocks = min((e4 + THREADS - 1) // THREADS, MAX_BLOCKS)
    f32 = lambda x: torch.tensor(np.float32(x))
    sqrt_p = f32(np.sqrt(np.float32(n_elems), dtype=np.float32))
    ema, ome = f32(EMA), f32(1 - EMA)
    lrs, gammas, cgs, vss = (scal[x] for x in ("lrs", "gammas", "cgs",
                                               "vscales"))
    q4 = lambda x: x.reshape(-1, 4)

    def next_avg(step, avg, j):
        rms = ((f32(lrs[j]) * f32(vss[j])) * sqrt_rn(_sum_partials(step))) \
            / sqrt_p
        return ema * avg + ome * rms

    avg0 = f32(ins["avg"])
    norm, step, slot = [None, None], [None, None], [None, None]
    norm[0] = _partials(q4(theta - sent[ids[0]]) ** 2, nblocks)
    avg = avg0
    hats, pres = [], []
    for j in range(k):
        i = ids[j]
        if fused:
            gap = sqrt_rn(_sum_partials(norm[j % 2])) / sqrt_p
            avg = avg0 if j <= 1 else slot[(j - 1) % 2]
            if j:
                avg = next_avg(step[(j - 1) % 2], avg, j - 1)
                slot[j % 2] = avg
        else:
            d = q4(theta - sent[i])
            gap = sqrt_rn(_sum_partials(_partials(d * d, nblocks))) / sqrt_p
        penalty = 1.0 + gap / torch.clamp(avg, min=1e-12)
        inv, inv_vs = 1.0 / penalty, 1.0 / f32(vss[j])
        vn = f32(gammas[j]) * v[i] + f32(cgs[j]) * (inv_vs * (inv * g[j]))
        pres.append(theta.clone())
        theta = ((-f32(lrs[j])) * f32(vss[j])) * vn + theta
        step[j % 2] = _partials(q4(vn * vn), nblocks)
        if fused and j + 1 < k:
            nxt = ids[j + 1]
            d = q4(theta - (theta if nxt == i else sent[nxt]))
            norm[(j + 1) % 2] = _partials(d * d, nblocks)
        v[i], sent[i] = vn, theta
        hats.append(theta)
        if not fused:
            avg = next_avg(step[j % 2], avg, j)
    if fused:
        avg = next_avg(step[(k - 1) % 2], avg0 if k <= 1
                       else slot[(k - 1) % 2], k - 1)
    return theta, v, sent, avg, torch.stack(hats), torch.stack(pres)


# R = 8320: 266,240 float4s, so the 1,024-block grid strides twice and the
# second sweep is ragged
KERNEL_IDS = {"1": [2], "2-adjacent": [1, 1], "4": [0, 2, 0, 1],
              "4-adjacent": [1, 1, 0, 1]}


@pytest.mark.parametrize("case", KERNEL_IDS)
def test_kernel_launch_order_model_matches_plain_version(case):
    """The k + 2 launches' arithmetic, modelled in its fixed summation
    order, within GAP_TOL of the plain version (torch.sum's order)."""
    ids = KERNEL_IDS[case]
    r, n, n_elems = 8320, 3, 8320 * 128 - 77
    ins, scal = _inputs(r, n, len(ids), seed=20 + len(ids), n_elems=n_elems)
    model = _kernel_model(ins, scal, ids, n_elems, fused=True)
    port = _port(ins, scal, ids, n_elems)
    plain = (port[0], port[1], port[4], port[5], torch.stack(port[6]),
             port[7])
    for name, a, b in zip(("theta", "v", "sent", "avg_step", "hats",
                           "pres"), model, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", KERNEL_IDS)
def test_kernel_launch_order_equals_two_pass_order_bit_for_bit(case):
    """Folding message j+1's norm into message j's pass and avg_step into
    the next launch changes no sum's order: the results are bit for bit
    the two-pass design's (the CUDA source's claim)."""
    ids = KERNEL_IDS[case]
    r, n = 8320, 3
    ins, scal = _inputs(r, n, len(ids), seed=30 + len(ids))
    fused = _kernel_model(ins, scal, ids, r * 128, fused=True)
    two_pass = _kernel_model(ins, scal, ids, r * 128, fused=False)
    for a, b in zip(fused, two_pass):
        assert torch.equal(a, b)
