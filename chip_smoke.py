#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

The main path is the paper's asynchronous master: the discrete-event
engine (``run_simulation``) running DANA-Zero on flat state through the
two hand-written CUDA kernels, ``flat_update_batch`` (the batched master
update) and ``send_view`` (the look-ahead view).  Full width: the MLP
classifier [2048, 4096, 4096, 10] has 25,214,986 parameters, the size of
the paper's ImageNet ResNet-50 master state, and 64 workers (the
paper's largest cluster) hold a 6.46 GB momentum slab; batches of 256
per worker (16K in total).  Depth is cut to 256 gradients.

Phases (one JSON line each):
  device      the card, its power limit, the CUDA and PyTorch versions
  build       nvcc builds both kernels from csrc/ (seconds, ptxas report)
  flat_update_batch / send_view
              each kernel against its plain PyTorch version on the same
              inputs at the main path's shapes and the other modes, with
              the tolerance stated; CUDA-event times (median of 20) beside
              the least time the card could take (bound) and the plain
              version's time
  main_path   run_simulation with the kernels (launch counts read around
              it), then the same run on the tree path without kernels:
              identical event stream, final parameters within 1e-3
              relative L2, every loss finite
The last lines: the kernel table as JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.  Any failed check raises and
the script exits non-zero; without a CUDA device it exits 2 at once.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

DIMS = [2048, 4096, 4096, 10]
WORKERS = 64
GRADS = 256
EVAL_EVERY = 64
LR = 0.01
BATCH = 256
R_FULL = 197_000          # rows of the flat layout of DIMS (checked below)
R_SMALL = 4_096
IDS8 = [3, 17, 3, 40, 63, 17, 0, 3]
REPS = 20
ELEM_TOL = dict(rtol=1e-6, atol=1e-6)
WEIGHTED_TOL = dict(rtol=1e-5, atol=1e-5)
# peak device-memory rate and f32 (non-tensor-core) rate by SKU: NVIDIA
# data sheets; the SXM H100 is the default H100
BANDWIDTH = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12,
             "H200": 4.8e12}
F32_RATE = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100": 67e12,
            "H200": 67e12}
SRC = "src/repro_torch/kernels/flat_update/csrc/flat_update.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sku(name):
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name:
            return key
    raise RuntimeError(f"no peak rates known for {name!r}")


def time_ms(fn, reps=REPS):
    """Median CUDA-event time of one call, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_err(a, b, tol, what, scale=None):
    """Max |a-b|; raises unless |a-b| <= atol + rtol*scale everywhere.
    ``scale`` is |b| for elementwise results; for a reordered N-way sum
    it is the sum of the magnitudes (the reordering's error bound)."""
    d = (a - b).abs()
    scale = b.abs() if scale is None else scale
    ok = bool(torch.all(d <= tol["atol"] + tol["rtol"] * scale))
    if not (ok and torch.isfinite(a).all()):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {d.max().item()}, "
                             f"tolerance {tol})")
    return d.max().item()


class Card:
    def __init__(self):
        self.smi = nvidia_smi()
        self.name = torch.cuda.get_device_name(0)
        self.bw = BANDWIDTH[sku(self.name)]
        self.f32 = F32_RATE[sku(self.name)]

    def bound(self, nbytes, nops):
        tb, to = nbytes / self.bw * 1e3, nops / self.f32 * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")


# -- flat_update_batch --------------------------------------------------
MODES = {
    # name: (rows, nesterov, v0, u2, sent+dc+sent_view, hat, telemetry)
    "dana-zero": (R_FULL, False, True, False, False, "v0", False),
    "dana-slim": (R_FULL, True, False, False, False, "theta", False),
    "adaptive": (R_SMALL, True, True, True, False, "v0", False),
    "sent+dc+sent_view": (R_SMALL, False, True, False, True, "v0", False),
    "self": (R_SMALL, False, False, False, False, "self", False),
    "weighted": (R_SMALL, False, True, False, False, "weighted", False),
    "telemetry": (R_SMALL, False, True, False, False, "v0", True),
}


def batch_inputs(rows, n, ids, nesterov, use_v0, use_u2, use_sent, hat,
                 telemetry, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = len(ids)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    state = {"theta": randn(rows, 128), "v": randn(n, rows, 128) * 0.1}
    state["v0"] = state["v"].sum(0) if use_v0 else None
    state["u2"] = randn(rows, 128).abs() * 0.01 if use_u2 else None
    state["sent"] = (state["theta"] + 0.01 * randn(n, rows, 128)
                     if use_sent else None)
    g = randn(k, rows, 128)
    lrs = np.linspace(0.05, 0.03, k).astype(np.float32)
    lrs_next = np.linspace(0.049, 0.029, k).astype(np.float32)
    gammas = np.full(k, 0.9, np.float32)
    cgs = np.full(k, 0.1 if use_u2 else 1.0, np.float32)
    vscales = np.linspace(1.0, 0.8, k).astype(np.float32)
    hcs = (lrs_next * gammas) * vscales
    rng = np.random.default_rng(seed)
    weights = (rng.random((k, n)).astype(np.float32) + 0.5
               if hat == "weighted" else None)
    args = (g, np.asarray(ids), lrs, gammas, cgs, vscales, hcs)
    kw = dict(nesterov=nesterov, dc_lambda=2.0 if use_sent else None,
              sent_view=use_sent, hat_mode=hat, weights=weights,
              telemetry=telemetry)
    return state, args, kw


def batch_bytes_ops(rows, n, ids, use_v0, use_u2, use_sent, hat, telemetry,
                    nesterov):
    p, k, u = rows * 128, len(ids), len(set(ids))
    streams = (2 + 2 * use_v0 + 2 * use_u2 + 2 * u * (1 + use_sent) + k + k
               + k * telemetry + (k * n if hat == "weighted" else 0))
    ops = (4 + 2 + 3 * nesterov + 2 * use_v0 + 7 * use_u2 + 4 * use_sent
           + {"theta": 0, "v0": 2, "self": 2, "weighted": 2 * n + 2}[hat])
    return 4 * p * streams, p * k * ops


def check_batch(card, label, rows, n, ids, nesterov, use_v0, use_u2,
                use_sent, hat, telemetry, time_it, seed):
    from repro_torch.kernels.flat_update.kernel import flat_update_batch
    from repro_torch.kernels.flat_update.ref import (
        flat_master_update_batch_ref)
    state, args, kw = batch_inputs(rows, n, ids, nesterov, use_v0, use_u2,
                                   use_sent, hat, telemetry, seed)
    names = ("theta", "v", "v0", "u2", "sent")
    ka = {x: None if state[x] is None else state[x].clone() for x in names}
    pa = {x: None if state[x] is None else state[x].clone() for x in names}
    del state
    outs = flat_update_batch(*(ka[x] for x in names), *args, **kw)
    g, ids_np, lrs, gammas, cgs, vscales, hcs = args
    ref = flat_master_update_batch_ref(
        *(pa[x] for x in names), None, g, ids_np, lrs, None, gammas, cgs,
        vscales, hcs=hcs, **kw)
    ref = ref[:5] + ref[6:]
    torch.cuda.synchronize()
    tol = WEIGHTED_TOL if hat == "weighted" else ELEM_TOL
    err = 0.0
    for nm, a, b in zip(names + ("hats", "pres"), outs, ref):
        if (a is None) != (b is None):
            raise AssertionError(f"{label}: {nm} present in one only")
        if a is not None:
            err = max(err, max_err(a, b, tol, f"{label} {nm}"))
    rec = {"phase": "flat_update_batch", "mode": label, "R": rows, "N": n,
           "k": len(ids), "ids": list(ids), "max_abs_err": err,
           "tolerance": tol}
    if time_it:
        st = [ka[x] for x in names]
        rec["ms"] = time_ms(lambda: flat_update_batch(*st, *args, **kw))
        pst = [pa[x] for x in names]
        rec["plain_ms"] = time_ms(lambda: flat_master_update_batch_ref(
            *pst, None, g, ids_np, lrs, None, gammas, cgs, vscales,
            hcs=hcs, **kw))
        nbytes, nops = batch_bytes_ops(rows, n, ids, use_v0, use_u2,
                                       use_sent, hat, telemetry, nesterov)
        rec["bytes"] = nbytes
        rec["bound_ms"], rec["bound_by"] = card.bound(nbytes, nops)
    emit(rec)
    return rec


def phase_flat_update(card):
    recs = {}
    for label, (rows, nest, v0, u2, sent, hat, tel) in MODES.items():
        recs[label] = check_batch(card, label, rows, WORKERS, IDS8, nest,
                                  v0, u2, sent, hat, tel, time_it=True,
                                  seed=len(recs))
        torch.cuda.empty_cache()
    # the engine's shape: one message per batch (the main path)
    recs["main"] = check_batch(card, "dana-zero k=1 (main path)", R_FULL,
                               WORKERS, [17], False, True, False, False,
                               "v0", False, time_it=True, seed=99)
    torch.cuda.empty_cache()
    return recs


# -- send_view -----------------------------------------------------------
def check_send(card, label, rows, n, adaptive, seed, library=False):
    from repro_torch.kernels.flat_update.send import (flat_send_view,
                                                      flat_send_view_ref)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    theta = torch.randn((rows, 128), generator=gen, device="cuda")
    slab = torch.randn((n, rows, 128), generator=gen, device="cuda")
    w = (torch.ones(n, device="cuda") if n == 1 else
         torch.rand(n, generator=gen, device="cuda") + 0.5)
    u2 = (torch.randn((rows, 128), generator=gen, device="cuda").abs()
          * 0.01 if adaptive else None)
    c = np.float32(0.05) * np.float32(0.9)
    out = flat_send_view(theta, slab, w, c, u2)
    ref = flat_send_view_ref(theta, slab, w, c, u2=u2)
    # |theta| + |c| * sum_j |w_j slab_j| [/ (sqrt(u2) + eps)]
    scale = (None if n == 1 else
             flat_send_view_ref(theta.abs(), slab.abs(), w.abs(), -abs(c),
                                u2=u2))
    torch.cuda.synchronize()
    tol = ELEM_TOL if n == 1 else WEIGHTED_TOL
    rec = {"phase": "send_view", "mode": label, "R": rows, "N": n,
           "adaptive": adaptive,
           "max_abs_err": max_err(out, ref, tol, f"send_view {label}",
                                  scale),
           "tolerance": tol,
           "ms": time_ms(lambda: flat_send_view(theta, slab, w, c, u2)),
           "plain_ms": time_ms(lambda: flat_send_view_ref(theta, slab, w,
                                                          c, u2=u2))}
    p = rows * 128
    nbytes = 4 * p * (n + 2 + adaptive)
    rec["bytes"] = nbytes
    rec["bound_ms"], rec["bound_by"] = card.bound(
        nbytes, p * (2 * n + 2 + 3 * adaptive))
    rec["library_ms"] = None
    if library:
        v0 = slab[0]
        rec["library_ms"] = time_ms(
            lambda: torch.add(theta, v0, alpha=-float(c)))
    emit(rec)
    return rec


def phase_send_view(card):
    recs = {"main": check_send(card, "dana-zero N=1 (main path)", R_FULL, 1,
                               False, seed=11, library=True)}
    torch.cuda.empty_cache()
    recs["weighted"] = check_send(card, "weighted N=64", R_FULL, WORKERS,
                                  False, seed=12)
    torch.cuda.empty_cache()
    recs["adaptive"] = check_send(card, "adaptive N=64", R_FULL, WORKERS,
                                  True, seed=13)
    torch.cuda.empty_cache()
    return recs


# -- the main path -------------------------------------------------------
def main_path():
    """The main path's configuration (also profiled by
    ``scripts/torch_profile_main_path.py``): returns (params0, run), where
    ``run(use_kernel, grads=GRADS)`` drives ``run_simulation`` once on the
    card and returns (history, wall seconds)."""
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.engine import SimulationConfig, run_simulation
    from repro_torch.core.types import HyperParams
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.models.toy import make_classifier_fns

    task = ClassificationTask(dim=DIMS[0], num_classes=DIMS[-1],
                              batch_size=BATCH, device="cuda")
    init, grad_fn, make_eval = make_classifier_fns(DIMS)
    eval_fn = make_eval(task.eval_batch())
    params0 = init(np.random.default_rng(0), device="cuda")
    algo = make_algorithm("dana-zero", HyperParams(lr=LR, momentum=0.9))

    def run(use_kernel, grads=GRADS):
        cfg = SimulationConfig(num_workers=WORKERS, total_grads=grads,
                               eval_every=EVAL_EVERY, use_kernel=use_kernel,
                               device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = run_simulation(algo, grad_fn, params0, task.batch, cfg,
                              eval_fn)
        torch.cuda.synchronize()
        return hist, time.perf_counter() - t0

    return params0, run


def phase_main_path():
    from repro_torch.core.flat import FlatSpec
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels.flat_update import launches, reset_launches

    params0, run = main_path()
    spec = FlatSpec.from_tree(params0)
    n_params = spec.n_elems
    if spec.rows != R_FULL:
        raise AssertionError(f"layout has {spec.rows} rows, expected "
                             f"{R_FULL}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist_k, secs_k = run(True)
    counts = launches()
    peak_k = torch.cuda.max_memory_allocated()
    if counts["send_view"] < WORKERS or counts["flat_update_batch"] != GRADS:
        raise AssertionError(f"main path did not run through the kernels: "
                             f"{counts}")
    final_k = [l.clone() for l in tree_leaves(hist_k.final_params)]
    hist_k.final_params = None
    torch.cuda.empty_cache()
    reset_launches()
    hist_t, secs_t = run(False)
    tree_counts = launches()
    for key in ("time", "worker", "lag", "step"):
        if getattr(hist_k, key) != getattr(hist_t, key):
            raise AssertionError(f"event stream differs in {key!r}")
    final_t = tree_leaves(hist_t.final_params)
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(final_k,
                                                             final_t))
    den = sum(float(torch.sum(b ** 2)) for b in final_t)
    rel = (num / den) ** 0.5
    finite = (all(np.isfinite(hist_k.eval_loss))
              and all(np.isfinite(hist_t.eval_loss))
              and all(bool(torch.isfinite(l).all()) for l in final_k))
    shapes = [tuple(l.shape) for l in final_k] == [
        tuple(l.shape) for l in tree_leaves(params0)]
    rec = {"phase": "main_path", "algorithm": "dana-zero", "lr": LR,
           "momentum": 0.9, "dims": DIMS, "params": n_params,
           "rows": spec.rows, "workers": WORKERS, "grads": GRADS,
           "batch_per_worker": BATCH,
           "eval_loss_kernel": hist_k.eval_loss,
           "eval_acc_kernel": hist_k.eval_metric,
           "eval_loss_tree": hist_t.eval_loss,
           "seconds_kernel_path": secs_k, "seconds_tree_path": secs_t,
           "messages_per_s_kernel_path": GRADS / secs_k,
           "messages_per_s_tree_path": GRADS / secs_t,
           "launches": counts, "launches_tree_path": tree_counts,
           "peak_mem_gb_kernel_path": peak_k / 1e9,
           "final_params_rel_l2_kernel_vs_tree": rel,
           "mean_lag": hist_k.mean_lag(), "mean_gap": hist_k.mean_gap()}
    emit(rec)
    if not finite or not shapes:
        raise AssertionError("main path produced non-finite values or "
                             "wrong shapes")
    if rel > 1e-3:
        raise AssertionError(f"kernel path and tree path disagree: "
                             f"relative L2 {rel}")
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.flat_update import _build
    card = Card()
    emit({"phase": "device", "nvidia_smi": card.smi, "kind": card.name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "numpy": np.__version__,
          "python": sys.version.split()[0],
          "peak_bandwidth_Bps": card.bw, "peak_f32_flops": card.f32})
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_INFO.get("seconds"),
          "ptxas": [ln for ln in _build.BUILD_INFO.get("ptxas", "")
                    .splitlines() if "registers" in ln or "spill" in ln]})
    fu = phase_flat_update(card)
    sv = phase_send_view(card)
    main_rec = phase_main_path()
    kernels = []
    for name, rec, replaces in (
            ("flat_update_batch", fu["main"],
             "src/repro/kernels/flat_update/kernel.py:226"),
            ("send_view", sv["main"],
             "src/repro/kernels/flat_update/send.py:86")):
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": replaces, "launches": main_rec["launches"][name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms")})
    kernels[0]["also_replaces"] = "src/repro/kernels/flat_update/kernel.py:497"
    emit({"kernels": kernels})
    print(card.smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card.name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
