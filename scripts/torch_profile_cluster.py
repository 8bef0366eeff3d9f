#!/usr/bin/env python3
"""Profile the PyTorch port's free-mode cluster on one GPU: where the
time goes.

    python3 scripts/torch_profile_cluster.py

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
round trip).  Exits 2 without a CUDA device.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (puts src/ on the path)


def main():
    if not torch.cuda.is_available():
        print("torch_profile_cluster: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.obs import trace

    conf = chip_smoke.configuration()
    kw = dict(mode="free", coalesce=8, record_telemetry=True)
    chip_smoke.run_cluster_once(conf, total_grads=128, **kw)   # warm-up
    acts = [torch.profiler.ProfilerActivity.CUDA]
    trace.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            _, stats, counts, wall, peak = chip_smoke.run_cluster_once(
                conf, total_grads=chip_smoke.FREE_GRADS, **kw)
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
        "phase": "profile_cluster_free", "grads": chip_smoke.FREE_GRADS,
        "workers": chip_smoke.WORKERS, "coalesce": 8, "wall_s": wall,
        "updates_per_s": chip_smoke.FREE_GRADS / wall,
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "coalesce_counts": stats["coalesce_counts"],
        "master_busy_share": stats["master_busy_s"] / wall,
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
