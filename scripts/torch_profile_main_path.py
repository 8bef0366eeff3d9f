#!/usr/bin/env python3
"""Profile the PyTorch port's main path on one GPU: where the time goes.

    python3 scripts/torch_profile_main_path.py

Runs the main path exactly as ``chip_smoke.py`` configures it (its
``main_path``: the full-width DANA-Zero simulation, 64 workers, 256
gradients, the flat path through the CUDA kernels) once on 64 gradients
to warm up, then once in full under ``torch.profiler`` (CPU and CUDA
activities), and prints one JSON line: the profiled run's wall seconds
and messages per second, the device's busy seconds (the sum of the
device time of every kernel, copy and set on the run's one stream, which
do not overlap) and idle share, the device time by name (top 12), and
the host time to draw one batch with numpy.  Exits 2 without a CUDA
device.
"""
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (puts src/ on the path)


def main():
    if not torch.cuda.is_available():
        print("torch_profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.kernels.flat_update import launches, reset_launches

    _, run = chip_smoke.main_path()
    run(True, grads=chip_smoke.WORKERS)      # warm-up: build, cuBLAS
    task = ClassificationTask(dim=chip_smoke.DIMS[0],
                              num_classes=chip_smoke.DIMS[-1],
                              batch_size=chip_smoke.BATCH, device="cuda")
    t0 = time.perf_counter()
    for j in range(32):
        task.batch(j % chip_smoke.WORKERS, 10_000 + j)
    host_batch_ms = (time.perf_counter() - t0) / 32 * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = run(True)
    counts = launches()
    # device-side entries only (kernels, copies, sets): a CPU op such as
    # aten::mm also carries the device time of the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted(((a.key, a.self_device_time_total, a.count)
                  for a in prof.key_averages()
                  if a.device_type == cuda
                  and a.self_device_time_total > 0), key=lambda x: -x[1])
    busy = sum(d[1] for d in dev) / 1e6
    print(json.dumps({
        "phase": "profile_main_path", "grads": chip_smoke.GRADS,
        "workers": chip_smoke.WORKERS, "wall_s": wall,
        "messages_per_s": chip_smoke.GRADS / wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "host_batch_ms": host_batch_ms, "launches": counts,
        "device_ms_by_name": [
            {"name": k[:80], "ms": t / 1e3, "count": c}
            for k, t, c in dev[:12]],
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
