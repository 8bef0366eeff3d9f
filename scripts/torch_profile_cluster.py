#!/usr/bin/env python3
"""Profile the PyTorch port's free-mode cluster on one GPU: where the
time goes.

    python3 scripts/torch_profile_cluster.py [--legacy | --shards S]

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
busy share printed too).  Exits 2 without a CUDA device.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (puts src/ on the path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legacy", action="store_true")
    ap.add_argument("--shards", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_cluster: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.obs import trace

    conf = chip_smoke.configuration()
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
