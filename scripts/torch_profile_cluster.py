#!/usr/bin/env python3
"""Profile the PyTorch port's free-mode cluster on one GPU: where the
time goes.

    python3 scripts/torch_profile_cluster.py [--legacy | --shards S]
    python3 scripts/torch_profile_cluster.py --backend process [--shards S]
        [--workers N] [--cap C]

Runs ``chip_smoke.py``'s ``cluster_free`` configuration (the full-width
DANA-Zero cluster, 64 worker threads, coalescing up to 8 messages,
telemetry on) once on 128 gradients to warm up, then once on 512
gradients with the port's span tracer (``repro_torch.obs.trace``) on and
under ``torch.profiler`` (CUDA activity only: host-side op recording in
65 threads would slow the host that sets the pace), and prints one JSON
line: wall seconds and updates per second, the device's busy seconds
(the summed device time of every kernel, copy and set on the run's one
stream) and idle share, device time by name (top 12), the drained-k
histogram, the master's share of wall time spent in its apply spans,
and the mean span time per name (master apply, worker gradient, worker
round trip).  With ``--legacy`` it profiles ``cluster_legacy`` instead
(deterministic, ``use_kernel=True, flat=False``: one
``dana_master_update`` per leaf per message; 16 gradients to warm up,
then 64).  With ``--shards S`` it profiles the same free run on the
row-sharded master (``sharded_free``: S shard threads, each shard's
busy share printed too).

With ``--backend process`` the same free run (512 gradients, S shards,
``--workers`` workers, 64 by default) runs on the process backend
(``--cap`` ring slots a shard, 16 by default: at 64 workers the ring,
the state, the view buffers and 65 CUDA contexts fill the 80 GB card)
and then on the thread backend, each with a metrics registry: one JSON
line a run with updates per second, each shard's busy share, the
mailbox-depth gauges the publisher sampled (from shared memory on the
process backend), and, from ``chip_smoke.MemSampler`` every 100 ms, the
card's utilization as ``nvidia-smi`` reports it (the process backend's
kernels run in other processes, out of this process's profiler's sight),
the card's peak used memory and each process's; then the spawn seconds
and the workers' host seconds by loop part.  First it prints what
shrinking a context's stack reservation frees (the children's
``_lean_stack``, here on this process's own context).
Exits 2 without a CUDA device.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (puts src/ on the path)


def lean_stack_bytes():
    """The card memory that lowering this process's per-thread stack
    reservation to the process backend's children's value frees."""
    import ctypes

    from repro_torch.cluster import procs

    limit = ctypes.c_size_t()
    procs._libcuda(("cuCtxGetLimit", ctypes.byref(limit),
                   procs._CU_LIMIT_STACK_SIZE))
    before = limit.value
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    procs._lean_stack()
    torch.cuda.synchronize()
    return {"phase": "lean_stack", "stack_bytes_before": before,
            "stack_bytes_after": procs._STACK_BYTES,
            "freed_bytes": torch.cuda.mem_get_info()[0] - free0}


def profile_backends(conf, shards, workers, cap):
    """The free run on the process backend, then the thread backend, each
    with a metrics registry and the card's utilization sampled."""
    import gc

    from repro_torch.cluster import ClusterConfig, run_cluster
    from repro_torch.obs import MetricsRegistry

    task, grad_fn, eval_fn, params0, algo = conf
    # the process run first: at 64 workers its children need the card's
    # memory that the thread run would leave cached in this process
    for backend in ("process", "thread"):
        kw = dict(num_workers=workers, device="cuda",
                  mode="free", coalesce=8, record_telemetry=True,
                  total_grads=chip_smoke.FREE_GRADS, shards=shards,
                  eval_every=chip_smoke.EVAL_EVERY, backend=backend)
        if backend == "process":
            kw["mailbox_capacity"] = cap
        stats, reg = {}, MetricsRegistry()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with chip_smoke.MemSampler(interval=0.1) as mem:
            run_cluster(algo, grad_fn, params0, task.batch,
                        ClusterConfig(**kw), eval_fn, stats_out=stats,
                        metrics=reg)
        util = mem.utilization
        depth = {}
        for track, pts in stats.get("obs_series", {}).items():
            if track.startswith("mailbox_depth"):
                vals = [v for _, v in pts]
                depth[track] = {"mean": sum(vals) / max(len(vals), 1),
                                "max": max(vals, default=0.0),
                                "samples": len(vals)}
        busy = stats.get("shard_busy_s", [stats["master_busy_s"]])
        print(json.dumps({
            "phase": f"profile_cluster_{backend}", "shards": shards,
            "grads": chip_smoke.FREE_GRADS,
            "workers": workers,
            "seconds": time.perf_counter() - t0,
            "wall_s": stats["wall_s"],
            "updates_per_s": stats["updates_per_s"],
            "steady_updates_per_s": stats["steady_updates_per_s"],
            "mean_coalesce": stats["mean_coalesce"],
            "coalesce_counts": stats["coalesce_counts"],
            "shard_busy_share": [b / stats["wall_s"] for b in busy],
            "depth_gauges": depth,
            "card_utilization_mean": (sum(util) / len(util) / 100.0
                                      if util else None),
            "utilization_samples": len(util),
            "card_used_max_gb": mem.device_used_max / 1e9,
            "process_memory_max_mib": mem.per_pid,
            "spawn_s": stats.get("spawn_s"),
            "worker_seconds": stats.get("worker_seconds"),
            "ring_bytes": stats.get("ring_bytes"),
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legacy", action="store_true")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--backend", choices=["thread", "process"],
                    default="thread")
    ap.add_argument("--workers", type=int, default=chip_smoke.WORKERS,
                    help="--backend process: workers of both runs")
    ap.add_argument("--cap", type=int, default=16,
                    help="--backend process: ring slots a shard")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_cluster: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.obs import trace

    conf = chip_smoke.configuration()
    if args.backend == "process":
        print(json.dumps(lean_stack_bytes()), flush=True)
        profile_backends(chip_smoke.procs_conf(conf), args.shards,
                         args.workers, args.cap)
        return 0
    if args.legacy:
        phase, grads, warm = ("profile_cluster_legacy",
                              chip_smoke.LEGACY_GRADS, 16)
        kw = dict(mode="deterministic", use_kernel=True, flat=False)
    else:
        phase, grads, warm = "profile_cluster_free", chip_smoke.FREE_GRADS, 128
        kw = dict(mode="free", coalesce=8, record_telemetry=True)
        if args.shards > 1:
            phase = "profile_cluster_sharded"
            kw["shards"] = args.shards
    chip_smoke.run_cluster_once(conf, total_grads=warm, **kw)   # warm-up
    acts = [torch.profiler.ProfilerActivity.CUDA]
    trace.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            _, stats, counts, wall, peak = chip_smoke.run_cluster_once(
                conf, total_grads=grads, **kw)
    finally:
        trace.disable()
    spans: dict = {}
    for e in trace.export()["traceEvents"]:
        if e["ph"] == "X":
            n, s = spans.get(e["name"], (0, 0.0))
            spans[e["name"]] = (n + 1, s + e["dur"] / 1e6)
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted(((a.key, a.self_device_time_total, a.count)
                  for a in prof.key_averages()
                  if a.device_type == cuda
                  and a.self_device_time_total > 0), key=lambda x: -x[1])
    busy = sum(d[1] for d in dev) / 1e6
    print(json.dumps({
        "phase": phase, "grads": grads, "workers": chip_smoke.WORKERS,
        "options": kw, "wall_s": wall, "updates_per_s": grads / wall,
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "coalesce_counts": stats["coalesce_counts"],
        "master_busy_share": stats["master_busy_s"] / wall,
        "shard_busy_share": [b / wall for b in stats.get("shard_busy_s",
                                                          [])],
        "launches": counts, "peak_mem_gb": peak / 1e9,
        "span_mean_ms": {k: s / n * 1e3 for k, (n, s) in spans.items()},
        "span_count": {k: n for k, (n, _) in spans.items()},
        "device_ms_by_name": [
            {"name": k[:80], "ms": t / 1e3, "count": c}
            for k, t, c in dev[:12]],
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
