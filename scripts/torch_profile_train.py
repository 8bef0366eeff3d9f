#!/usr/bin/env python3
"""Profile the PyTorch port's DANA pod-round train step on one GPU.

    python3 scripts/torch_profile_train.py [--arch qwen2-1.5b]
        [--pods 2] [--batch 8] [--seq 512]

Builds the train state as ``chip_smoke.py``'s ``train_qwen2`` does
(qwen2-1.5b at full width and depth by default, f32 state, bf16
compute, random weights from a seed); ``--arch recurrentgemma-9b`` and
``--arch falcon-mamba-7b`` take ``train_rg``'s and ``train_mamba``'s
depth cuts (``chip_smoke.TRAIN_CUTS``).  Runs two warm-up steps, then
one step under ``torch.profiler`` with CUDA activity only, and one
more with the host's too.  Prints one JSON line: the first profiled
step's wall seconds, the device's busy seconds (the summed device time
of every kernel, copy and set on the one stream), the idle share, the
number of device events, the device time by kind (GEMMs, the
hand-written kernels, elementwise, reductions, softmax, copies,
indexing) and by name (top 15), the launch counts of a step; and from
the second step the host operators with the most self time (top 15;
recording them slows the host, so that step's wall time is not the
step's).  Exits 2 without a CUDA device.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (puts src/ on the path)

# device-time kinds, matched in order against the kernel's name
KINDS = (("swa_attention", ("swa_attention",)),
         ("rglru_scan", ("rglru",)),
         ("mamba_scan", ("mamba_scan",)),
         ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "sm80_",
                   "ampere", "cublas", "gemv", "dot_kernel")),
         ("softmax", ("softmax", "logsumexp")),
         ("reduce", ("reduce",)),
         ("index", ("index", "scatter", "gather", "embedding", "sort",
                    "radix")),
         ("copy", ("copy", "memcpy", "memset", "cat", "fill")),
         ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _kind(name):
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=chip_smoke.TRAIN_ARCH)
    ap.add_argument("--pods", type=int, default=chip_smoke.TRAIN_PODS)
    ap.add_argument("--batch", type=int, default=chip_smoke.TRAIN_BATCH)
    ap.add_argument("--seq", type=int, default=chip_smoke.TRAIN_SEQ)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves
    from repro_torch.data.synthetic import LMTask
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.steps import (TrainSettings, build_train_step,
                                          init_train_state)
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config(args.arch),
                              **chip_smoke.TRAIN_CUTS.get(args.arch, {}))
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(
        device="cuda").manual_seed(0), args.pods, "cuda")
    task = LMTask(vocab_size=cfg.vocab_size, seq_len=args.seq,
                  batch_size=args.batch, device="cuda")
    step = build_train_step(model, TrainSettings(lr=3e-3))
    for i in range(2):                                   # warm-up
        state, m = step(state, {"tokens": task.batch(0, i)})
    float(m["loss"])
    batch = {"tokens": task.batch(0, 2)}
    torch.cuda.synchronize()
    reset_launches()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launches()
    acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as host:
        state, m = step(state, {"tokens": task.batch(0, 3)})
        float(m["loss"])
    ops = sorted(((a.key, a.self_cpu_time_total, a.count)
                  for a in host.key_averages()), key=lambda x: -x[1])
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted(((a.key, a.self_device_time_total, a.count)
                  for a in prof.key_averages()
                  if a.device_type == cuda and a.self_device_time_total > 0),
                 key=lambda x: -x[1])
    busy = sum(t for _, t, _ in dev) / 1e6
    by_kind = {}
    for name, t, c in dev:
        k = by_kind.setdefault(_kind(name), {"ms": 0.0, "count": 0})
        k["ms"] += t / 1e3
        k["count"] += c
    print(json.dumps({
        "phase": "profile_train_step", "arch": cfg.name,
        "num_layers": cfg.num_layers, "pods": args.pods,
        "batch": args.batch, "seq": args.seq,
        "params": sum(l.numel() for l in tree_leaves(state["theta"])),
        "loss": loss, "wall_s": wall, "tok_per_s": args.batch * args.seq
        / wall, "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
        "device_events": sum(c for _, _, c in dev),
        "launches": {k: n for k, n in counts.items() if n},
        "device_ms_by_kind": dict(sorted(by_kind.items(),
                                         key=lambda kv: -kv[1]["ms"])),
        "device_ms_by_name": [{"name": k[:80], "ms": t / 1e3, "count": c}
                              for k, t, c in dev[:15]],
        "host_self_ms_by_op": [{"name": k[:60], "ms": t / 1e3, "count": c}
                               for k, t, c in ops[:15]],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
