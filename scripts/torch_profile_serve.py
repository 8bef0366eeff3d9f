#!/usr/bin/env python3
"""Profile the PyTorch port's serve path on one GPU: where the time goes.

    python3 scripts/torch_profile_serve.py [--arch recurrentgemma-9b]
        [--batch 4] [--prompt 512] [--gen 32]
    python3 scripts/torch_profile_serve.py --arch granite-moe-3b-a800m
    python3 scripts/torch_profile_serve.py --arch llama4-scout-17b-a16e \
        [--layers 14]

Builds the model (falcon-mamba-7b by default; recurrentgemma-9b,
chatglm3-6b, qwen2-vl-7b, granite-moe-3b-a800m or llama4-scout-17b-a16e)
as ``chip_smoke.py``'s serve phases do (full width, full depth but for
llama4-scout, whose depth ``--layers`` cuts, 14 by default as in
``chip_smoke.py``; bf16, random weights from a seed), warms up with a
short ``generate`` call, then runs ``generate`` (batch 4, prompt 512, 32 new tokens by
default; ``--batch 1 --prompt 3072 --gen 16`` is
``serve_generate_rg_long``'s shape) once with the launch counts set to 0
and once under ``torch.profiler`` (CUDA activity only: recording every
host op would slow the host that sets the decode loop's pace), and the
prefill alone under it too.  Prints one JSON line: wall seconds,
prefill and decode tokens per second, the device's busy seconds (the
summed device time of every kernel, copy and set on the one stream),
their number, and the idle share for the whole call and for the
prefill, the device time by name (top 15), and each of the model's
hand-written kernels' device time per launch (``mamba_scan``;
``rglru_scan`` and ``swa_attention``).  For a MoE config it also
profiles one call of the dispatch loop (``mlp.dispatch_tensors``, the
top_k one-hot slots) at a decode step's routes (one group of one token
a row) and at the prefill's (groups of 256): its device events a call,
and those a decode step summed over the layers.  Exits 2 without a
CUDA device.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (puts src/ on the path)


def _device_times(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((a.key, a.self_device_time_total, a.count)
                   for a in prof.key_averages()
                   if a.device_type == cuda
                   and a.self_device_time_total > 0), key=lambda x: -x[1])


KERNELS = {"falcon-mamba-7b": ("mamba_scan",),
           "recurrentgemma-9b": ("rglru_scan", "swa_attention"),
           "chatglm3-6b": ("swa_attention",),
           "qwen2-vl-7b": ("swa_attention",),
           "granite-moe-3b-a800m": ("swa_attention",),
           "llama4-scout-17b-a16e": ("swa_attention",)}


def _dispatch_events(cfg, groups, g, reps=5):
    """Device events of one ``dispatch_tensors`` call on random routes of
    ``groups`` groups of ``g`` tokens, and the capacity it ran at."""
    from repro_torch.models import mlp
    gen = torch.Generator(device="cuda").manual_seed(0)
    probs = torch.rand((groups, g, cfg.num_experts), device="cuda",
                       generator=gen)
    top_p, top_i = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    _, _, cap = mlp.moe_capacity(g, cfg.num_experts, cfg.experts_per_tok,
                                 cfg.capacity_factor)

    def call():
        return mlp.dispatch_tensors(top_p, top_i, cfg.num_experts, cap,
                                    torch.bfloat16)
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    dev = _device_times(prof)
    return {"groups": groups, "group_size": g, "capacity": cap,
            "device_events_per_call": sum(c for _, _, c in dev) / reps,
            "device_ms_per_call": sum(t for _, t, _ in dev) / 1e3 / reps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b", choices=KERNELS)
    ap.add_argument("--batch", type=int, default=chip_smoke.SERVE_BATCH)
    ap.add_argument("--prompt", type=int, default=chip_smoke.SERVE_PROMPT)
    ap.add_argument("--gen", type=int, default=chip_smoke.SERVE_GEN)
    ap.add_argument("--layers", type=int,
                    default=chip_smoke.LLAMA4_CUT["num_layers"],
                    help="llama4-scout-17b-a16e's depth cut")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_serve: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.serve import generate, serve_batch
    from repro_torch.models.attention import CacheSpec

    cut = (dict(num_layers=args.layers, unit_repeats=0)
           if args.arch == chip_smoke.LLAMA4_ARCH else {})
    model, params, info = chip_smoke.serve_model(args.arch, **cut)
    prompts = chip_smoke.serve_prompts(model.cfg, 0, args.batch, args.prompt)
    generate(model, params, prompts[:, :64], 2)             # warm-up
    reset_launches()
    _, stats = generate(model, params, prompts, args.gen)
    counts = launches()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        generate(model, params, prompts, args.gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = _device_times(prof)
    busy = sum(d[1] for d in dev) / 1e6
    spec = CacheSpec(args.prompt + args.gen, None)
    batch = serve_batch(model.cfg, prompts)
    with torch.profiler.profile(activities=acts) as prof_p:
        t0 = time.perf_counter()
        model.prefill(params, batch, spec)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    dev_p = _device_times(prof_p)
    busy_p = sum(d[1] for d in dev_p) / 1e6

    def kernel_ms(rows, name):
        hits = [(t, c) for k, t, c in rows if name in k]
        return ({"ms_per_launch": sum(t for t, _ in hits) / 1e3
                 / sum(c for _, c in hits), "launches": sum(
                     c for _, c in hits)} if hits else None)

    per_kernel = {}
    for name in KERNELS[args.arch]:
        per_kernel[f"{name}_device"] = kernel_ms(dev, name)
        per_kernel[f"{name}_device_prefill"] = kernel_ms(dev_p, name)
    cfg = model.cfg
    if cfg.num_experts:
        decode = _dispatch_events(cfg, args.batch, 1)
        decode["device_events_per_decode_step"] = \
            decode["device_events_per_call"] * cfg.num_layers
        per_kernel["dispatch_loop_decode"] = decode
        per_kernel["dispatch_loop_prefill"] = _dispatch_events(
            cfg, args.batch * args.prompt // min(256, args.prompt),
            min(256, args.prompt))
        per_kernel["decode_device_events_per_step"] = (
            sum(c for _, _, c in dev) - sum(c for _, _, c in dev_p)) \
            / max(args.gen - 1, 1)

    print(json.dumps({
        "phase": "profile_serve_generate", "arch": model.cfg.name,
        "batch": args.batch, "prompt": args.prompt, "gen": args.gen,
        **info, **stats, "launches": counts,
        "layers": model.cfg.num_layers,
        "profiled_wall_s": wall, "device_busy_s": busy,
        "device_events": sum(c for _, _, c in dev),
        "prefill_device_events": sum(c for _, _, c in dev_p),
        "device_idle_share": 1.0 - busy / wall,
        "prefill_wall_s": wall_p, "prefill_device_busy_s": busy_p,
        "prefill_device_idle_share": 1.0 - busy_p / wall_p,
        **per_kernel,
        "device_ms_by_name": [
            {"name": k[:80], "ms": t / 1e3, "count": c}
            for k, t, c in dev[:15]],
        "prefill_device_ms_by_name": [
            {"name": k[:80], "ms": t / 1e3, "count": c}
            for k, t, c in dev_p[:10]],
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
