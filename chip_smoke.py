#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU and check them.

    python3 chip_smoke.py

The paths are the paper's asynchronous master: the discrete-event engine
(``run_simulation``) and the threaded parameter-server cluster
(``run_cluster``), running DANA-Zero through the hand-written CUDA
kernels ``flat_update_batch`` (the batched master update), ``send_view``
(the look-ahead view) and ``dana_master_update`` (the legacy
per-message round), ga-asgd through ``gap_update`` (the gap-aware
master update), and the other flat-eligible members through
``flat_update_batch`` and ``send_view``; falcon-mamba-7b's serve path
(``launch.serve.generate`` and the continuous-batching ``serve.Engine``)
through the Mamba-1 selective scan ``mamba_scan``; and recurrentgemma-9b's
serve path (the same entry points) through the RG-LRU scan
``rglru_scan`` and causal sliding-window attention ``swa_attention``;
the reduced models' gradients through the scan and attention
kernels; and the LM training path: qwen2-1.5b trained at full width and
depth by ``launch.train.main`` (DANA's pod round, 2 pods; every dense
``attn`` layer through ``swa_attention`` with a window of S), the pod
round on recurrentgemma-9b and falcon-mamba-7b at full width with their
depth cut, and the cluster's ``--preset lm``.
Full width: the MLP
classifier [2048, 4096, 4096, 10] has 25,214,986 parameters, the size
of the paper's ImageNet ResNet-50 master state, and 64 workers (the
paper's largest cluster) hold a 6.46 GB momentum slab (and ga-asgd,
dana-dc and dc-asgd as large a snapshot slab); batches of 256 per worker
(16K in total).  Depth is cut to 256 gradients (engine, deterministic
cluster, sharded deterministic), 512 (free cluster, sharded free), 64
(legacy kernel path), 128 (ga-asgd engine, deterministic and sharded
clusters), 192 (the hot-row run), 256 (ga-asgd free cluster), 32 (each
other member) and 2 rounds of 64 (ssgd).  The row-sharded master's shards
are threads on the card; the process backend runs its shard servers
and workers as processes (16 workers: its cut; 128 pinned messages, 512
free).  falcon-mamba-7b runs at its published widths
(d_model 4096, d_inner 8192, ssm_state 16, conv 4, dt_rank 256, vocab
65,024) and full depth (64 layers, 7.3B parameters, 14.6 GB in bf16);
recurrentgemma-9b (arXiv:2402.19427) at its published widths (d_model
4096, 16 heads, 1 kv head, head_dim 256, d_ff 12288, d_inner 4096, 16
RG-LRU heads, conv 4, window 2048, vocab 256,000) and full depth (38
layers = 2 + 12 x (rec, rec, attn_local), 9.63B parameters, 19.3 GB in
bf16).  Each model's random weights are drawn from a seeded generator
on the card; falcon-mamba is freed before recurrentgemma is drawn.

Phases (one JSON line each):
  device      the card, its power limit, the CUDA and PyTorch versions,
              and what a CUDA-event pair reads around an empty call
  build       nvcc builds every kernel library from csrc/, one nvcc per
              source, all started together (seconds, ptxas report)
  flat_update_batch / send_view / dana_master_update / gap_update /
  mamba_scan / rglru_scan / swa_attention
              each kernel against its plain PyTorch version on the same
              inputs at its paths' shapes and the other modes, with the
              tolerance stated; CUDA-event times (median of 20) beside
              the least time the card could take (bound) and the plain
              version's time; gap_update twice on the same inputs, bit
              for bit, at k=1, k=8 (repeats apart), k=2 of one worker
              and k=8 with an adjacent pair, with its device time a call,
              its kernels a call (k + 2; a profile whose count is no
              whole number a call lost records and is taken again, up
              to 3) and the bytes of its one-pass and the earlier
              two-pass design; send_view in its three modes (N=1 bit for
              bit, rate-weighted and adaptive N=64) with each mode's
              device time from torch.profiler, and at N=1 in turns with
              torch.add; mamba_scan timed at the prefill shape (B=4,
              S=512, D=8192, N=16), the Engine's one-request prefill
              (B=1, S=256, on bf16 xc with B and C split from a bf16
              projection, as the Engine serves it) and a decode step
              (S=1), each with its device time, its last state bit for
              bit the plain version's and its bounds; checked at S=77
              with a nonzero h0, at N=8, at D=1002 (plain staging), on
              bf16 xc with B and C split from a bf16 projection as
              apply_mamba passes them (prefill and decode), and split
              in two calls chained through the last state;
              rglru_scan bit for bit at recurrentgemma-9b's prefill shape
              (B=4, S=512, D=4096), the long prompt (1, 3072, 4096) and
              a decode step (S=1), each timed with its device time and
              bound (the decode call in turns with torch.addcmul), at
              S=77 with D=1000 and a nonzero h0, at S=5 (shorter than a
              stage) with D=1002, at S=1 with D=1001, and chained;
              swa_attention (bf16, the
              tensor-core kernel, timed, with its device time from
              torch.profiler and its TFLOP/s; f32, the CUDA-core kernel,
              checked; 2e-5 f32, 3e-2 bf16) at (B=4, S=512, H=16, K=1,
              hd=256, window 2048) and (1, 3072, ...), where the band is
              narrower than the sequence, and at S=1000, window 128, hd
              64, K=H; beside it SDPA with the band as a boolean mask
  swa_attention_dense
              swa_attention at qwen2-1.5b's training shape (bf16, one
              pod's batch: B=4, S=512, 12 heads, 2 kv heads, hd 128,
              window 512 = plain causal) against its plain version,
              timed with its device time beside SDPA (is_causal=True,
              K/V repeated to 12 heads) and its bound
  lm_grad     falcon-mamba-7b-reduced, recurrentgemma-9b-reduced and
              qwen2-1.5b-reduced in
              float32: sum(logits * W) backward on the card (the kernels
              forward, their plain versions' gradients backward) and on
              the CPU (plain versions throughout), parameters from one
              seeded draw, tokens and W from numpy; every leaf's gradient
              finite and within 1e-4 relative L2 of the CPU's, every
              kernel of the model launched once a prologue layer and
              twice a unit layer (each unit repeat is checkpointed)
  main_path   run_simulation with the kernels, then the same run on the
              tree path without kernels: identical event stream, final
              parameters within 1e-3 relative L2, every loss finite
  cluster_deterministic
              run_cluster, deterministic, flat kernel path: final
              parameters, event stream, telemetry and eval losses bit for
              bit those of main_path's kernel run
  cluster_free
              run_cluster, free mode, coalescing up to 8 messages per
              flat_update_batch launch, telemetry on: updates/s, the
              drained-k histogram (some batch must have k > 1), peak
              device memory, finite losses
  cluster_legacy
              run_cluster, deterministic, use_kernel=True, flat=False:
              dana_master_update once per leaf per message; final
              parameters bit for bit the tree path's without kernels
  main_path_ga
              run_simulation with ga-asgd: gap_update once per message,
              then the tree path: identical event stream, final
              parameters within 1e-3 relative L2, every loss finite
  cluster_ga_deterministic
              run_cluster, deterministic, ga-asgd on the flat path: bit
              for bit main_path_ga's kernel run (parameters, events,
              telemetry with the snapshot staleness, eval losses)
  cluster_ga_free
              run_cluster, free, ga-asgd, coalescing up to 8: gap_update
              once per message, the drained-k histogram
  members     each other new member (sa-asgd, dc-asgd, lwp, dana-dc,
              dana-hetero, nadam-asgd, dana-nadam) on the engine's
              kernel path and on its tree path, as main_path
  sharded_deterministic
              run_cluster, deterministic, dana-zero, 4 row-range shards
              (threads on the card): final parameters, events and eval
              losses bit for bit main_path's kernel run;
              flat_update_batch 4 a message, send_view 4 an initial view
  sharded_free
              4 shards, free, coalescing up to 8, telemetry on: updates/s
              beside cluster_free's, each shard's applied count and busy
              seconds, the drained-k histogram
  procs_pinned
              the process backend (shard servers and workers as spawned
              processes, ring slots on the card shared through CUDA IPC)
              at full width with 16 worker processes (64 would hold 65
              CUDA contexts and spawn for about two minutes a run;
              scripts/torch_profile_cluster.py --backend process runs
              64): dana-zero, 2 shards, pin_schedule, 128 messages,
              beside the thread backend's pinned run: final parameters
              bit for bit, identical worker/lag/step streams; the shard
              children's flat_update_batch 2 a message, the parent's
              send_view 2 a worker; the reckoned memory before, the
              card's used memory, utilization, spawn seconds after
  procs_free  free, coalescing up to 8, 512 messages, 16 worker
              processes, at S = 1, 2, 4, beside the thread backend's
              single master at 16 workers and this call's cluster_free and
              sharded_free (64 threads): updates/s, the drained k, each
              shard's applied count and busy share, spawn seconds, the
              workers' host seconds by loop part; flat_update_batch a
              shard a drained batch in the children
  hot_rows    send_view over three row ranges of the layout (the first
              layer's block, a middle range, the last rows), the slab
              read in place through its pitch: dana-zero's view_rows
              (N=1) bit for bit the full view's rows and the plain
              version, the N=64 weighted send bit for bit the full call's
              rows (the plain version within 1e-5), device times beside
              the full view's and each range's bound; then a free run
              whose workers 1-4 drop out and rejoin through pulls of
              their declared hot rows
  procs_ga    ga-asgd on the process backend, 1 shard, pinned, 128
              messages, 16 worker processes: within rtol 1e-5 / atol
              1e-6 of the thread backend's pinned run, gap_update once a
              message in the shard child (k + 2 kernels a drained batch)
  sharded_ga  ga-asgd, 2 shards, deterministic, the gap norms summed over
              the shards' partials: final parameters within rtol 1e-5 /
              atol 1e-6 of main_path_ga's single master
  member ssgd / easgd / dana-easgd / yellowfin
              run_simulation at full width on the tree path (ssgd 2
              barrier rounds of 64 gradients, the others 32 messages):
              finite losses, no kernel launched; at [2048, 256, 256, 10]
              with 8 workers, batches of 32 and 8 messages (ssgd 2
              rounds of 8) the card's final parameters within 1e-4
              relative L2 of the CPU's
  serve_generate
              falcon-mamba-7b in bf16, batch 4, prompt 512, 32 new
              tokens through generate: prefill and decode tokens/s, peak
              device memory, 2048 mamba_scan launches (one per layer per
              prefill and decode step); then prefill + one decode step
              against forward over prompt + token (bf16, atol 0.15)
  serve_engine
              the Engine, 4 slots, capacity 512, 8 seeded requests
              (prompts of 20-250 tokens, 8-24 new tokens): all finish,
              slots are reused, one mamba_scan per layer per prefill and
              decode step; each request's first two tokens against a
              lone prefill (and decode) of its left-padded bucket wherever
              the top-2 logit margin exceeds 0.15
  serve_generate_rg
              recurrentgemma-9b in bf16, batch 4, prompt 512, 32 new
              tokens: 832 rglru_scan launches (26 rec layers x 32) and 12
              swa_attention (one per attn_local layer in the prefill);
              prefill + one decode step against forward (atol 0.15)
  serve_generate_rg_long
              batch 1, prompt 3072, 16 new tokens: each local cache
              (capacity 2048) comes from the roll branch of the ring
              buffer (shift 1024) and decode writes slots 1024-1039; the
              same checks over 3073 tokens
  serve_engine_rg
              the Engine as serve_engine: 26 rglru_scan launches per
              admission and per engine step, 12 swa_attention per
              admission; per-slot steps and ring positions
  train_qwen2 launch.train.main on qwen2-1.5b at full width and depth
              (28 layers, 1.78B parameters; f32 state: theta, 2 pod
              momenta, v0), --pods 2 --batch 8 --seq 512 --steps 6
              --ckpt-every 3 into build/chip_smoke_ckpt: s/step, tok/s,
              peak device memory, each step's loss (finite); v0 equal to
              the pods' momenta summed, bit for bit; 672 swa_attention
              launches (28 layers x 2 pods x 6 steps x 2: each unit
              repeat is checkpointed, so the backward recomputes its
              forward); then the same command again, which resumes from
              the step-3 checkpoint: 336 launches, steps 4-6's losses
              and the final state's checksums equal to the first run's
              bit for bit.  Each run ends after its step 6, before the
              step-6 save, so the script writes one 28.4 GB checkpoint
              (its disk writes stay under 45 GB)
  train_rg / train_mamba
              build_train_step on recurrentgemma-9b (depth cut to one
              pattern unit: rec, rec, attn_local, no prologue) and
              falcon-mamba-7b (depth cut to 2 layers) at published
              widths: 1 pod, batch 2, 512 tokens, 2 steps; finite
              losses; rglru_scan / swa_attention / mamba_scan twice a
              layer a step
  cluster_lm_deterministic / cluster_lm_free
              launch.cluster.main --preset lm (qwen2-1.5b reduced with
              the tiny-LM overrides, 64-token sequences): dana-zero, 4
              workers, 64 gradients, deterministic with
              --compare-engine (BIT-EXACT; the CLI's deterministic mode
              takes the tree path, as the JAX CLI's), then free
              coalescing up to 4 (one flat_update_batch a drained
              batch): updates/s and launches
  cluster_lm_procs
              launch.cluster.main --preset lm --backend process: 2
              worker processes, 32 gradients, free: a finite loss, the
              shard child's flat_update_batch a drained batch and the
              workers' swa_attention launches, counted in the children
  cluster_lm_full
              run_cluster, deterministic, flat kernel path, on
              qwen2-1.5b at full width with its depth cut to 2 layers
              (ModelGradFn(reduced=False, overrides=...): 560M
              parameters), 4 workers, 16 gradients: flat_update_batch
              and send_view first checked against their plain versions
              at this model's packed rows; then the engine with the
              kernels (final parameters bit for bit the cluster's) and
              on the tree path without kernels (within 1e-3 relative L2)
Every path runs with the launch counts set to 0 just before it and read
just after; a path that did not launch its kernels fails (a process
backend's children count in their own processes and ship their counts
back; the parent sums them).  The last
lines: the kernel table as JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  Any failed check raises and the script
exits non-zero; without a CUDA device it exits 2 at once.
"""
import json
import os
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
FREE_GRADS = 512          # cluster_free: gradients through the free cluster
LEGACY_GRADS = 64         # cluster_legacy: per-message dana_update rounds
EVAL_EVERY = 64
LR = 0.01
BATCH = 256
R_FULL = 197_000          # rows of the flat layout of DIMS (checked below)
R_SMALL = 4_096
IDS8 = [3, 17, 3, 40, 63, 17, 0, 3]
IDS8_ADJACENT = [3, 17, 17, 40, 63, 5, 0, 3]
REPS = 20
ERR_CHUNK = 1 << 28       # elements a pass of max_err
ELEM_TOL = dict(rtol=1e-6, atol=1e-6)
WEIGHTED_TOL = dict(rtol=1e-5, atol=1e-5)
# gap_update: the gap and step norms are sums of 25M f32 terms, which
# the kernel and torch.sum add in different orders (relative error
# about 1e-6 at most); the penalty carries that into every element, and
# duplicate ids and the avg_step chain carry it across messages
GAP_TOL = dict(rtol=1e-5, atol=1e-6)
GA_GRADS = 128            # main_path_ga and cluster_ga_deterministic
GA_FREE_GRADS = 256       # cluster_ga_free
MEMBER_GRADS = 32         # each other new member, engine paths
MEMBERS = ("sa-asgd", "dc-asgd", "lwp", "dana-dc", "dana-hetero",
           "nadam-asgd", "dana-nadam")
# Adam-sized rate for the Nadam pair (at the others' rate every element
# moves by about lr per step, whatever its gradient)
MEMBER_LR = {"nadam-asgd": 1e-3, "dana-nadam": 1e-3}
SHARDS = 4                # sharded_deterministic / sharded_free
GA_SHARDS = 2             # sharded_ga
SHARDED_GA_TOL = dict(rtol=1e-5, atol=1e-6)
HOT_GRADS = 192           # hot_rows: the free run with declared hot rows
OFFFLAT = ("ssgd", "easgd", "dana-easgd", "yellowfin")
OFFFLAT_GRADS = 32        # each asynchronous off-flat member
SSGD_ROUNDS = 2           # ssgd: rounds of WORKERS gradients
OFFFLAT_CPU_DIMS = [2048, 256, 256, 10]   # the card against the CPU,
OFFFLAT_CPU_WORKERS = 8                   # with 8 workers, batches of
OFFFLAT_CPU_BATCH = 32                    # 32 and 8 messages (ssgd: 2
OFFFLAT_CPU_GRADS = 8                     # rounds of 8), for seconds
OFFFLAT_CPU_TOL = 1e-4                    # relative L2
# peak device-memory rate and f32 (non-tensor-core) rate by SKU: NVIDIA
# data sheets; the SXM H100 is the default H100
BANDWIDTH = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12,
             "H200": 4.8e12}
F32_RATE = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100": 67e12,
            "H200": 67e12}
SRC = "src/repro_torch/kernels/flat_update/csrc/flat_update.cu"
DANA_SRC = "src/repro_torch/kernels/dana_update/csrc/dana_update.cu"
GAP_SRC = "src/repro_torch/kernels/flat_update/csrc/gap_update.cu"
EXACT = dict(rtol=0.0, atol=0.0)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SCAN_SRC = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
# mamba_scan: the state rounds as the plain version rounds it (-fmad=false,
# IEEE expf); y's N-sum is taken in another order, so its error is held
# against the sum of the magnitudes
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# exponentials per clock on each SM (special-function units; CUDA C++
# Programming Guide, arithmetic instruction throughput, compute 9.0)
SFU_PER_SM_CLOCK = 16
SERVE_ARCH = "falcon-mamba-7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
# bf16 logits: the JAX package's own tolerance for prefill + decode
# against forward (tests/test_models_smoke.py), and the top-2 margin above
# which two bf16 paths must pick the same token
SERVE_TOL = dict(rtol=0.15, atol=0.15)
ENGINE_REQUESTS, ENGINE_SLOTS, ENGINE_CAPACITY = 8, 4, 512
# dense bf16 tensor-core rate by SKU (NVIDIA data sheets), the peak that
# bounds attention's products on bf16 inputs
BF16_RATE = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H100": 989e12,
             "H200": 989e12}
RG_ARCH = "recurrentgemma-9b"
RG_LONG_BATCH, RG_LONG_PROMPT, RG_LONG_GEN = 1, 3072, 16
RGLRU_SRC = "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu"
SWA_SRC = "src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu"
# swa_attention: the JAX package's kernel tolerances (tests/test_kernels.py)
SWA_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
           torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


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


def time_pair(fn_a, fn_b, reps=4 * REPS):
    """Median CUDA-event times of two calls taken in turns (a, b, b, a,
    ...), so that drift on the host touches both alike."""
    for fn in (fn_a, fn_b, fn_a, fn_b):
        fn()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(reps):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            (fn_a, fn_b)[j]()
            b.record()
            b.synchronize()
            times[j].append(a.elapsed_time(b))
    return float(np.median(times[0])), float(np.median(times[1]))


def profiled(fn, names, reps=REPS, attempts=3, required=True):
    """{name: (device us, kernels)} over ``reps`` calls of ``fn`` (after a
    warm-up call), from torch.profiler's CUDA activity in one window, for
    the kernels whose names contain each of ``names``.  The profiler
    loses kernel records now and then (PERF.md): a window that shows no
    record of a name is taken again, up to ``attempts`` windows; then a
    name still unseen raises, or with ``required=False`` is left out."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [a for a in prof.key_averages()
                if a.device_type == torch.autograd.DeviceType.CUDA
                and a.self_device_time_total > 0]
        out = {}
        for name in names:
            hits = [(a.self_device_time_total, a.count) for a in seen
                    if name in a.key]
            if hits:
                out[name] = (sum(t for t, _ in hits),
                             sum(c for _, c in hits))
        if len(out) == len(names):
            return out
    if not required:
        return out
    raise AssertionError(f"the profiler saw no device time of "
                         f"{sorted(set(names) - set(out))} in {attempts} "
                         f"windows (its CUDA records: "
                         f"{sorted({a.key for a in seen})[:10]})")


def device_ms(fn, name, reps=REPS, per_call=False):
    """Device time (ms) per launch of the kernels whose names contain
    ``name`` (per call of ``fn`` with ``per_call``), from torch.profiler's
    CUDA activity over ``reps`` calls (after a warm-up call): the
    wrapper's host work left out.  Where the profiler lost every record
    of the name in all its windows, the median CUDA-event time of a call
    (``time_ms``, the host's launch work included) stands in, and a line
    says so."""
    got = profiled(fn, [name], reps, required=False).get(name)
    if got is None:
        ms = time_ms(fn, reps)
        emit({"phase": "device_ms_from_events", "kernel": name, "ms": ms})
        return ms
    us, n = got
    return us / 1e3 / (reps if per_call else n)


def max_err(a, b, tol, what, scale=None):
    """Max |a-b|; raises unless |a-b| <= atol + rtol*scale everywhere.
    ``scale`` is |b| for elementwise results; for a reordered N-way sum
    it is the sum of the magnitudes (the reordering's error bound)."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    fs = None if scale is None else scale.reshape(-1)
    peaks, ok = [], True
    for i in range(0, fa.numel(), ERR_CHUNK):   # temporaries of 1 GiB
        part = slice(i, i + ERR_CHUNK)
        d = (fa[part] - fb[part]).abs()
        s = fb[part].abs() if fs is None else fs[part]
        ok = ok and bool(torch.all(d <= tol["atol"] + tol["rtol"] * s)) \
            and bool(torch.isfinite(fa[part]).all())
        peaks.append(d.max())
    worst = torch.stack(peaks).max().item()
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {worst}, "
                             f"tolerance {tol})")
    return worst


class Card:
    def __init__(self):
        self.smi = nvidia_smi()
        self.name = torch.cuda.get_device_name(0)
        self.bw = BANDWIDTH[sku(self.name)]
        self.f32 = F32_RATE[sku(self.name)]
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.max_sm_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
        self.exp_rate = self.sms * SFU_PER_SM_CLOCK * self.max_sm_mhz * 1e6
        self.bf16 = BF16_RATE[sku(self.name)]

    def bound(self, nbytes, nops, nexp=0):
        """The least time (ms): bytes at the memory rate, f32 operations at
        the f32 rate, exponentials at the special-function units' rate;
        the largest of the three, and which kind it is."""
        tb, to = nbytes / self.bw * 1e3, nops / self.f32 * 1e3
        te = nexp / self.exp_rate * 1e3
        return (tb, "bytes") if tb >= max(to, te) else \
            (max(to, te), "operations")


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
                use_sent, hat, telemetry, time_it, seed, wire=False):
    """``wire``: call the kernel as the cluster's master does, with the k
    gradients as separate buffers (the engine passes one (k, R, 128)
    tensor).  Each hat must come back in a buffer of its own."""
    from repro_torch.kernels.flat_update.kernel import flat_update_batch
    from repro_torch.kernels.flat_update.ref import (
        flat_master_update_batch_ref)
    state, args, kw = batch_inputs(rows, n, ids, nesterov, use_v0, use_u2,
                                   use_sent, hat, telemetry, seed)
    names = ("theta", "v", "v0", "u2", "sent")
    ka = {x: None if state[x] is None else state[x].clone() for x in names}
    pa = state                           # the plain version's, in place
    g, ids_np, lrs, gammas, cgs, vscales, hcs = args
    kargs = ([gj.clone() for gj in g],) + args[1:] if wire else args
    outs = list(flat_update_batch(*(ka[x] for x in names), *kargs, **kw))
    if len({h.untyped_storage().data_ptr() for h in outs[5]}) != len(ids):
        raise AssertionError(f"{label}: hats share buffers")
    outs[5] = torch.stack(outs[5])
    ref = flat_master_update_batch_ref(
        *(pa[x] for x in names), None, g, ids_np, lrs, None, gammas, cgs,
        vscales, hcs=hcs, **kw)
    ref = ref[:5] + (torch.stack(ref[6]), ref[7])
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
        rec["ms"] = time_ms(lambda: flat_update_batch(*st, *kargs, **kw))
        rec["device_ms"] = device_ms(
            lambda: flat_update_batch(*st, *kargs, **kw),
            "flat_update_batch")
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
    # the cluster master's call: k=8 drained messages, telemetry on,
    # separate gradient buffers in, one buffer per reply view out
    recs["cluster"] = check_batch(
        card, "dana-zero k=8 telemetry, cluster wire (cluster_free path)",
        R_FULL, WORKERS, IDS8, False, True, False, False, "v0", True,
        time_it=True, seed=98, wire=True)
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

    def call():
        return flat_send_view(theta, slab, w, c, u2)
    rec = {"phase": "send_view", "mode": label, "R": rows, "N": n,
           "adaptive": adaptive,
           "max_abs_err": max_err(out, ref, tol, f"send_view {label}",
                                  scale),
           "bit_equal": bool(torch.equal(out, ref)),
           "tolerance": tol,
           "device_ms": device_ms(call, "send_view"),
           "plain_ms": time_ms(lambda: flat_send_view_ref(theta, slab, w,
                                                          c, u2=u2))}
    p = rows * 128
    nbytes = 4 * p * (n + 2 + adaptive)
    rec["bytes"] = nbytes
    rec["bound_ms"], rec["bound_by"] = card.bound(
        nbytes, p * (2 * n + 2 + 3 * adaptive))
    rec["device_share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
    rec["library_ms"] = None
    if library:
        v0 = slab[0]

        def add():
            return torch.add(theta, v0, alpha=-float(c))
        # the kernel's call and torch.add's in turns
        rec["ms"], rec["library_ms"] = time_pair(call, add)
        rec["library_device_ms"] = device_ms(add, "add")
    else:
        rec["ms"] = time_ms(call)
    if n == 1 and not rec["bit_equal"]:
        raise AssertionError(f"send_view {label}: not bit-equal to its "
                             f"plain version")
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


# -- dana_master_update ------------------------------------------------
def mlp_shapes():
    """The main path's leaves in flatten order: per layer b, then w."""
    out = []
    for d_in, d_out in zip(DIMS[:-1], DIMS[1:]):
        out += [(d_out,), (d_in, d_out)]
    return out


def check_dana(card, label, shapes, dtype, tol, seed, offset=0):
    """The tree wrapper (one launch per leaf) against the plain version
    on the same leaves; times are for the whole tree (one message).
    ``offset`` > 0 starts every leaf that many elements into its buffer
    (pointers not 16-byte aligned)."""
    from repro_torch.kernels.dana_update import (dana_master_update,
                                                 dana_master_update_ref)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def tree(scale):
        return [torch.randn(int(np.prod(s)) + offset, generator=gen,
                            device="cuda").mul_(scale).to(dtype)[offset:]
                .view(s) for s in shapes]

    theta, v_i, g = tree(1.0), tree(0.1), tree(1.0)
    v0 = [a * 8 for a in tree(0.1)]
    lr, gamma = np.float32(LR), np.float32(0.9)
    outs = dana_master_update(theta, v_i, v0, g, lr, gamma)
    refs = [dana_master_update_ref(*xs, lr, gamma)
            for xs in zip(theta, v_i, v0, g)]
    torch.cuda.synchronize()
    err = 0.0
    for j, name in enumerate(("theta", "v_i", "v0", "hat")):
        for a, r in zip(outs[j], refs):
            if a.dtype != dtype:
                raise AssertionError(f"{label} {name}: dtype {a.dtype}")
            err = max(err, max_err(a.float(), r[j].float(), tol,
                                   f"dana_master_update {label} {name}"))
    n = sum(int(np.prod(s)) for s in shapes)
    nbytes = 8 * n * (4 if dtype == torch.float32 else 2)
    rec = {"phase": "dana_master_update", "mode": label,
           "dtype": str(dtype).split(".")[-1], "elements": n,
           "leaves": len(shapes), "max_abs_err": err, "tolerance": tol,
           "ms": time_ms(lambda: dana_master_update(theta, v_i, v0, g, lr,
                                                    gamma)),
           "plain_ms": time_ms(lambda: [dana_master_update_ref(
               *xs, lr, gamma) for xs in zip(theta, v_i, v0, g)]),
           "device_ms": device_ms(lambda: dana_master_update(
               theta, v_i, v0, g, lr, gamma), "dana_", per_call=True),
           "launches_a_call": len(shapes),
           "bytes": nbytes, "library_ms": None}
    rec["bound_ms"], rec["bound_by"] = card.bound(nbytes, 7 * n)
    emit(rec)
    return rec


def phase_dana_update(card):
    recs = {"main": check_dana(card, "MLP leaves (cluster_legacy path)",
                               mlp_shapes(), torch.float32, EXACT, 21)}
    torch.cuda.empty_cache()
    for label, dtype, tol in (("f32", torch.float32, EXACT),
                              ("bf16", torch.bfloat16, BF16_TOL)):
        recs[label] = check_dana(card, f"R={R_FULL} {label}",
                                 [(R_FULL, 128)], dtype, tol, 22)
        torch.cuda.empty_cache()
    # ragged leaves: the float4 body with a scalar tail; then the same
    # leaves with pointers that are not 16-byte aligned (all scalar)
    for offset in (0, 1):
        check_dana(card, f"ragged, offset {offset}",
                   [(1,), (17,), (1000,), (3, 5)], torch.float32, EXACT,
                   23, offset=offset)
    return recs


# -- gap_update ----------------------------------------------------------
def gap_bytes_ops(rows, ids, telemetry):
    """What k gap-aware messages must move, each input read once and each
    output written once: theta in/out, the u distinct v and sent rows
    in/out, k gradients in, k hats (and k pre-thetas) out; the one-pass
    design's own traffic (message 0's norm reads theta and its sent row;
    each message reads theta, v_i and g_j and writes theta, v_i, sent_i
    and the hat [and pre], and reads the next message's sent row unless
    it is its own); and the earlier two-pass design's, which read theta
    twice and the v and sent rows once per message.  About 12 f32
    operations per element per message (3 in the gap norm, 9 in the
    update and its norm)."""
    p, k, u = rows * 128, len(ids), len(set(ids))
    adjacent = sum(a == b for a, b in zip(ids, ids[1:]))
    least = 4 * p * (2 + 4 * u + 2 * k + k * telemetry)
    one_pass = 4 * p * (2 + k * (7 + telemetry) + k - 1 - adjacent)
    two_pass = 4 * p * k * (2 + 7 + telemetry)
    return least, one_pass, two_pass, 12 * p * k


def check_gap(card, label, rows, n, ids, seed):
    """The kernel twice on the same inputs (bit for bit), then against
    the plain version on the same inputs; telemetry on."""
    from repro_torch.kernels.flat_update.kernel import flat_update_batch_gap
    from repro_torch.kernels.flat_update.ref import (
        flat_master_update_batch_ref)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = len(ids)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    state = {"theta": randn(rows, 128), "v": randn(n, rows, 128) * 0.1}
    state["sent"] = state["theta"] + 0.01 * randn(n, rows, 128)
    state["avg"] = torch.full((), 1e-3, device="cuda")
    g = randn(k, rows, 128)
    scal = (np.linspace(0.05, 0.04, k).astype(np.float32),
            np.full(k, 0.9, np.float32), np.ones(k, np.float32),
            np.linspace(1.0, 0.9, k).astype(np.float32))
    kw = dict(gap_ema=0.99, n_elems=rows * 128, telemetry=True)
    names = ("theta", "v", "sent", "avg")
    runs = []
    for _ in range(2):
        st = [state[x].clone() for x in names]
        out = list(flat_update_batch_gap(*st, g, ids, *scal, **kw))
        out[4] = torch.stack(out[4])
        runs.append(out)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs[1]
    outs = runs[0]
    ref = flat_master_update_batch_ref(
        state["theta"], state["v"], None, None, state["sent"],
        state["avg"], g, ids, scal[0], None, scal[1], scal[2], scal[3],
        nesterov=False, gap_aware=True, hat_mode="theta", **kw)
    ref = (ref[0], ref[1], ref[4], ref[5], torch.stack(ref[6]), ref[7])
    torch.cuda.synchronize()
    errs = {}
    for nm, a, b in zip(("theta", "v", "sent", "avg_step", "hats", "pres"),
                        outs, ref):
        errs[nm] = max_err(a, b, GAP_TOL, f"gap_update {label} {nm}")
    del outs, ref
    rec = {"phase": "gap_update", "mode": label, "R": rows, "N": n, "k": k,
           "ids": list(ids), "max_abs_err": max(errs.values()),
           "max_abs_err_by_output": errs, "tolerance": GAP_TOL,
           "tolerance_reason": "norms of 25M f32 terms summed in another "
                               "order, carried through the penalty",
           "bit_identical_on_relaunch": identical}
    st = [state[x] for x in names]
    rec["ms"] = time_ms(lambda: flat_update_batch_gap(*st, g, ids, *scal,
                                                      **kw))
    rec["plain_ms"] = time_ms(lambda: flat_master_update_batch_ref(
        st[0], st[1], None, None, st[2], st[3], g, ids, scal[0], None,
        scal[1], scal[2], scal[3], nesterov=False, gap_aware=True,
        hat_mode="theta", **kw))
    # the host loop launches k + 2 kernels a call whatever the data, and
    # checks each launch, so a count that is no whole number a call says
    # the profiler lost records (seen at 3.1 and at 9.95 a call, with a
    # control of torch.add launches in the same window complete): such a
    # profile is taken again, up to 3 in all; a whole count other than
    # k + 2 fails
    for profiles in range(1, 4):
        us, n = profiled(lambda: flat_update_batch_gap(
            *st, g, ids, *scal, **kw), ["gap_"])["gap_"]
        if n % REPS == 0:
            break
    rec.update(device_ms=us / 1e3 / REPS, kernels_a_call=n / REPS,
               profiles=profiles)
    least, one_pass, two_pass, nops = gap_bytes_ops(rows, ids, True)
    rec["bytes"] = least
    rec["bound_ms"], rec["bound_by"] = card.bound(least, nops)
    rec["one_pass_bytes"] = one_pass
    rec["one_pass_bound_ms"] = card.bound(one_pass, nops)[0]
    rec["two_pass_bytes"] = two_pass
    rec["two_pass_bound_ms"] = card.bound(two_pass, nops)[0]
    rec["library_ms"] = None
    emit(rec)
    if not identical:
        raise AssertionError(f"gap_update {label}: two launches on the "
                             f"same inputs differ")
    if rec["kernels_a_call"] != k + 2:
        raise AssertionError(f"gap_update {label}: the profiler saw "
                             f"{rec['kernels_a_call']} kernels a call in "
                             f"{profiles} profiles, expected k + 2 = "
                             f"{k + 2}")
    return rec


def phase_gap_update(card):
    """k=1 (the engine's messages), k=8 with repeats apart (the free
    cluster's coalesced batches), k=2 of one worker and k=8 with an
    adjacent pair (the next message's gap taken as exactly 0)."""
    recs = {}
    for key, label, ids, seed in (
            ("main", "k=1 (main_path_ga)", [17], 31),
            ("k8", "k=8 duplicate ids (cluster_ga_free)", IDS8, 32),
            ("k2_adjacent", "k=2 one worker [5, 5]", [5, 5], 33),
            ("k8_adjacent", "k=8 with an adjacent pair", IDS8_ADJACENT,
             34)):
        recs[key] = check_gap(card, label, R_FULL, WORKERS, ids, seed=seed)
        torch.cuda.empty_cache()
    return recs


# -- the main path -------------------------------------------------------
def configuration(name="dana-zero", lr=LR):
    """The full-width configuration every path runs: (task, grad_fn,
    eval_fn, params0, algo) on the card."""
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.types import HyperParams
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.models.toy import make_classifier_fns

    task = ClassificationTask(dim=DIMS[0], num_classes=DIMS[-1],
                              batch_size=BATCH, device="cuda")
    init, grad_fn, make_eval = make_classifier_fns(DIMS)
    eval_fn = make_eval(task.eval_batch())
    params0 = init(np.random.default_rng(0), device="cuda")
    algo = make_algorithm(name, HyperParams(lr=lr, momentum=0.9))
    return task, grad_fn, eval_fn, params0, algo


def main_path(conf=None):
    """The engine's run (also profiled by
    ``scripts/torch_profile_main_path.py``): returns (params0, run), where
    ``run(use_kernel, grads=GRADS)`` drives ``run_simulation`` once on the
    card and returns (history, wall seconds)."""
    from repro_torch.core.engine import SimulationConfig, run_simulation

    task, grad_fn, eval_fn, params0, algo = conf or configuration()

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


def rel_l2(a_leaves, b_leaves):
    """Relative L2 of a against b over every leaf."""
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(a_leaves,
                                                             b_leaves))
    den = sum(float(torch.sum(b ** 2)) for b in b_leaves)
    return (num / den) ** 0.5


def engine_paths(conf, phase, grads, expect):
    """The engine on the flat kernel path, then on the tree path without
    kernels: the same event stream, final parameters within 1e-3
    relative L2, every loss finite.  ``expect(counts)`` is true iff the
    kernel run's launch counts show its kernels ran.  Returns (record,
    the kernel path's history and final parameters)."""
    from repro_torch.core.flat import FlatSpec
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import launches, reset_launches

    params0, run = main_path(conf)
    spec = FlatSpec.from_tree(params0)
    if spec.rows != R_FULL:
        raise AssertionError(f"layout has {spec.rows} rows, expected "
                             f"{R_FULL}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist_k, secs_k = run(True, grads)
    counts = launches()
    peak_k = torch.cuda.max_memory_allocated()
    final_k = [l.clone() for l in tree_leaves(hist_k.final_params)]
    hist_k.final_params = None
    torch.cuda.empty_cache()
    reset_launches()
    hist_t, secs_t = run(False, grads)
    tree_counts = launches()
    events_equal = all(getattr(hist_k, key) == getattr(hist_t, key)
                       for key in ("time", "worker", "lag", "step"))
    final_t = tree_leaves(hist_t.final_params)
    rel = rel_l2(final_k, final_t)
    eval_loss_t = hist_t.eval_loss
    del hist_t, final_t
    torch.cuda.empty_cache()
    finite = (all(np.isfinite(hist_k.eval_loss))
              and all(bool(torch.isfinite(l).all()) for l in final_k))
    shapes = [tuple(l.shape) for l in final_k] == [
        tuple(l.shape) for l in tree_leaves(params0)]
    algo = conf[4]
    rec = {"phase": phase, "algorithm": algo.name,
           "lr": float(algo.hp.lr), "momentum": 0.9, "dims": DIMS,
           "params": spec.n_elems, "rows": spec.rows, "workers": WORKERS,
           "grads": grads, "batch_per_worker": BATCH,
           "eval_loss_kernel": hist_k.eval_loss,
           "eval_acc_kernel": hist_k.eval_metric,
           "eval_loss_tree": eval_loss_t,
           "seconds_kernel_path": secs_k, "seconds_tree_path": secs_t,
           "messages_per_s_kernel_path": grads / secs_k,
           "messages_per_s_tree_path": grads / secs_t,
           "launches": counts, "launches_tree_path": tree_counts,
           "peak_mem_gb_kernel_path": peak_k / 1e9,
           "events_equal_to_tree_path": events_equal,
           "final_params_rel_l2_kernel_vs_tree": rel,
           "mean_lag": hist_k.mean_lag(), "mean_gap": hist_k.mean_gap()}
    emit(rec)
    if not expect(counts) or any(tree_counts.values()):
        raise AssertionError(f"{phase} did not run through its kernels: "
                             f"{counts}, tree path {tree_counts}")
    if not events_equal:
        raise AssertionError(f"{phase}: event streams differ")
    if not finite or not shapes:
        raise AssertionError(f"{phase} produced non-finite values or "
                             f"wrong shapes")
    if rel > 1e-3:
        raise AssertionError(f"{phase}: kernel path and tree path "
                             f"disagree: relative L2 {rel}")
    return rec, hist_k, final_k


def phase_main_path(conf):
    """DANA-Zero, GRADS messages: one flat_update_batch per message and
    one send_view per initial view."""
    return engine_paths(
        conf, "main_path", GRADS,
        lambda c: (c["flat_update_batch"] == GRADS
                   and c["send_view"] >= WORKERS))


def phase_main_path_ga():
    """ga-asgd, GA_GRADS messages: one gap_update per message; the views
    are copies of theta (no send_view), and nothing else launches."""
    conf = configuration("ga-asgd")
    rec, hist, final = engine_paths(
        conf, "main_path_ga", GA_GRADS,
        lambda c: (c["gap_update"] == GA_GRADS
                   and c["flat_update_batch"] == 0
                   and c["send_view"] == 0))
    return conf, rec, hist, final


def phase_members():
    """Every other new member, MEMBER_GRADS messages on each engine path:
    one flat_update_batch per message, and one send_view per initial
    view for the members whose send is a look-ahead."""
    from repro_torch.kernels.flat_update import SEND_KERNEL
    recs = {}
    for name in MEMBERS:
        sends = WORKERS if name in SEND_KERNEL else 0
        recs[name], _, _ = engine_paths(
            configuration(name, MEMBER_LR.get(name, LR)),
            f"member {name}", MEMBER_GRADS,
            lambda c, s=sends: (c["flat_update_batch"] == MEMBER_GRADS
                                and c["send_view"] == s
                                and c["gap_update"] == 0))
        torch.cuda.empty_cache()
    return recs


# -- the threaded cluster --------------------------------------------------
def run_cluster_once(conf, workers=WORKERS, **kw):
    """One ``run_cluster`` at full width with the launch counts set to 0
    just before it and read just after; returns (history, stats, counts,
    wall seconds, peak device bytes)."""
    import gc

    from repro_torch.cluster import ClusterConfig, run_cluster
    from repro_torch.kernels import launches, reset_launches

    task, grad_fn, eval_fn, params0, algo = conf
    kw.setdefault("eval_every", EVAL_EVERY)
    cfg = ClusterConfig(num_workers=workers, device="cuda", **kw)
    stats = {}
    gc.collect()           # an earlier run's worker threads hold views
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    hist = run_cluster(algo, grad_fn, params0, task.batch, cfg, eval_fn,
                       stats_out=stats)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (hist, stats, launches(), secs,
            torch.cuda.max_memory_allocated())


def cluster_record(phase, hist, stats, counts, secs, peak):
    from repro_torch.core.types import tree_leaves
    finite = (all(np.isfinite(hist.eval_loss)) and hist.eval_loss
              and all(bool(torch.isfinite(l).all())
                      for l in tree_leaves(hist.final_params)))
    if not finite:
        raise AssertionError(f"{phase}: non-finite losses or parameters")
    return {"phase": phase, "seconds": secs,
            "updates_per_s": stats["updates_per_s"],
            "steady_updates_per_s": stats["steady_updates_per_s"],
            "master_busy_s": stats["master_busy_s"],
            "master_updates_per_s": stats["master_updates_per_s"],
            "coalesce_counts": stats["coalesce_counts"],
            "mean_coalesce": stats["mean_coalesce"], "launches": counts,
            "peak_mem_gb": peak / 1e9, "eval_step": hist.eval_step,
            "eval_loss": hist.eval_loss, "mean_lag": hist.mean_lag(),
            "mean_gap": hist.mean_gap()}


def phase_cluster_deterministic(conf, hist_e, final_e,
                                phase="cluster_deterministic", grads=None,
                                expect=None):
    """The deterministic cluster on the flat kernel path: bit for bit
    the engine's kernel-path run (``hist_e``, ``final_e``): final
    parameters, events, telemetry (the snapshot staleness included) and
    eval losses."""
    from repro_torch.core.types import tree_leaves
    grads = GRADS if grads is None else grads
    hist, stats, counts, secs, peak = run_cluster_once(
        conf, mode="deterministic", total_grads=grads, use_kernel=True)
    rec = cluster_record(phase, hist, stats, counts, secs, peak)
    same = {key: getattr(hist, key) == getattr(hist_e, key)
            for key in ("time", "worker", "lag", "step", "gap",
                        "grad_norm", "eval_loss")}
    same["staleness"] = bool(np.array_equal(hist.staleness,
                                            hist_e.staleness,
                                            equal_nan=True))
    final = tree_leaves(hist.final_params)
    rec["final_params_bit_equal_to_engine"] = all(
        torch.equal(a, b) for a, b in zip(final, final_e))
    rec["equal_to_engine"] = same
    emit(rec)
    if expect is None:
        expect = (lambda c: c["flat_update_batch"] == GRADS
                  and c["send_view"] >= WORKERS)
    if not expect(counts):
        raise AssertionError(f"{phase} did not run through the kernels: "
                             f"{counts}")
    if not (rec["final_params_bit_equal_to_engine"] and all(same.values())):
        raise AssertionError(f"{phase} differs from the engine's kernel "
                             f"path")
    return rec


def phase_cluster_free(conf):
    """Free mode, coalescing up to 8 messages, telemetry on."""
    hist, stats, counts, secs, peak = run_cluster_once(
        conf, mode="free", total_grads=FREE_GRADS, coalesce=8,
        record_telemetry=True)
    rec = cluster_record("cluster_free", hist, stats, counts, secs, peak)
    emit(rec)
    batches = sum(stats["coalesce_counts"].values())
    if (stats["applied"] != FREE_GRADS or len(hist.gap) != FREE_GRADS
            or counts["flat_update_batch"] != batches):
        raise AssertionError(f"cluster_free: {stats['applied']} applied, "
                             f"{len(hist.gap)} telemetry rows, {counts}")
    if max(stats["coalesce_counts"]) < 2:
        raise AssertionError("cluster_free drained no batch with k > 1")
    return rec


def phase_cluster_ga_free(conf):
    """ga-asgd in free mode, coalescing up to 8 messages, telemetry on:
    one gap_update per message, whatever the drained k."""
    hist, stats, counts, secs, peak = run_cluster_once(
        conf, mode="free", total_grads=GA_FREE_GRADS, coalesce=8,
        record_telemetry=True)
    rec = cluster_record("cluster_ga_free", hist, stats, counts, secs, peak)
    rec["staleness_equals_lag"] = hist.staleness == [float(l)
                                                     for l in hist.lag]
    emit(rec)
    if (stats["applied"] != GA_FREE_GRADS
            or len(hist.gap) != GA_FREE_GRADS
            or counts["gap_update"] != GA_FREE_GRADS
            or counts["flat_update_batch"]):
        raise AssertionError(f"cluster_ga_free: {stats['applied']} applied, "
                             f"{len(hist.gap)} telemetry rows, {counts}")
    if not rec["staleness_equals_lag"]:
        raise AssertionError("cluster_ga_free: snapshot staleness is not "
                             "the lag")
    return rec


def phase_cluster_legacy(conf):
    """The legacy per-message dana_update path (use_kernel=True,
    flat=False) against the tree path without kernels."""
    from repro_torch.core.types import tree_leaves
    hist, stats, counts, secs, peak = run_cluster_once(
        conf, mode="deterministic", total_grads=LEGACY_GRADS,
        use_kernel=True, flat=False)
    rec = cluster_record("cluster_legacy", hist, stats, counts, secs, peak)
    final_l = [l.clone() for l in tree_leaves(hist.final_params)]
    events_l = [getattr(hist, k) for k in ("time", "worker", "lag", "gap")]
    del hist
    hist_t, _, counts_t, secs_t, _ = run_cluster_once(
        conf, mode="deterministic", total_grads=LEGACY_GRADS,
        use_kernel=False)
    final_t = tree_leaves(hist_t.final_params)
    rec["tree_path_seconds"] = secs_t
    rec["tree_path_launches"] = counts_t
    rec["max_abs_diff_vs_tree_path"] = max(
        float((a - b).abs().max()) for a, b in zip(final_l, final_t))
    rec["events_equal_to_tree_path"] = events_l == [
        getattr(hist_t, k) for k in ("time", "worker", "lag", "gap")]
    emit(rec)
    leaves = len(final_l)
    if (counts["dana_master_update"] != leaves * LEGACY_GRADS
            or counts["flat_update_batch"] or any(counts_t.values())):
        raise AssertionError(f"cluster_legacy launches: {counts}, tree "
                             f"path {counts_t}")
    if rec["max_abs_diff_vs_tree_path"] != 0.0 or \
            not rec["events_equal_to_tree_path"]:
        raise AssertionError("cluster_legacy differs from the tree path")
    return rec


# -- the row-sharded master, hot rows, the off-flat members ----------------
def phase_sharded_deterministic(conf, hist_e, final_e):
    """dana-zero, SHARDS shards, deterministic: final parameters, events
    and eval losses bit for bit main_path's engine kernel run; one
    flat_update_batch per shard per message, one send_view per shard
    per initial view."""
    from repro_torch.core.types import tree_leaves
    hist, stats, counts, secs, peak = run_cluster_once(
        conf, mode="deterministic", total_grads=GRADS, shards=SHARDS)
    rec = cluster_record("sharded_deterministic", hist, stats, counts,
                         secs, peak)
    rec["shards"] = SHARDS
    rec["shard_applied"] = stats["shard_applied"]
    rec["shard_busy_s"] = stats["shard_busy_s"]
    same = {key: getattr(hist, key) == getattr(hist_e, key)
            for key in ("time", "worker", "lag", "step", "eval_loss")}
    rec["final_params_bit_equal_to_engine"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(hist.final_params),
                                          final_e))
    rec["equal_to_engine"] = same
    emit(rec)
    if (counts["flat_update_batch"] != SHARDS * GRADS
            or counts["send_view"] != SHARDS * WORKERS
            or counts["gap_update"]):
        raise AssertionError(f"sharded_deterministic launches: {counts}")
    if not (rec["final_params_bit_equal_to_engine"] and all(same.values())):
        raise AssertionError("sharded_deterministic differs from the "
                             "engine's kernel path")
    return rec


def phase_sharded_ga(conf, final_e):
    """ga-asgd, GA_SHARDS shards, deterministic: the gap norms summed
    over the shards' partials (plain torch ops on the card, two host
    syncs a message); final parameters within SHARDED_GA_TOL of
    main_path_ga's single master (through gap_update)."""
    from repro_torch.core.types import tree_leaves
    hist, stats, counts, secs, peak = run_cluster_once(
        conf, mode="deterministic", total_grads=GA_GRADS, shards=GA_SHARDS)
    rec = cluster_record("sharded_ga", hist, stats, counts, secs, peak)
    rec["shards"] = GA_SHARDS
    rec["shard_applied"] = stats["shard_applied"]
    final = tree_leaves(hist.final_params)
    rec["max_abs_err_vs_single_master"] = max(
        max_err(a, b, SHARDED_GA_TOL, "sharded_ga final parameters")
        for a, b in zip(final, final_e))
    rec["tolerance"] = SHARDED_GA_TOL
    rec["final_params_rel_l2_vs_single_master"] = rel_l2(final, final_e)
    emit(rec)
    if any(counts.values()) or stats["shard_applied"] != [GA_GRADS] * \
            GA_SHARDS:
        raise AssertionError(f"sharded_ga: launches {counts}, applied "
                             f"{stats['shard_applied']}")
    return rec


def phase_sharded_free(conf, single):
    """dana-zero, SHARDS shards, free, coalescing up to 8, telemetry on:
    updates/s beside cluster_free's (the single master), each shard's
    applied count and busy seconds, the drained-k histogram; one
    flat_update_batch per shard per drained batch."""
    hist, stats, counts, secs, peak = run_cluster_once(
        conf, mode="free", total_grads=FREE_GRADS, coalesce=8,
        record_telemetry=True, shards=SHARDS)
    rec = cluster_record("sharded_free", hist, stats, counts, secs, peak)
    rec.update(shards=SHARDS, shard_applied=stats["shard_applied"],
               shard_busy_s=stats["shard_busy_s"],
               telemetry_dropped=stats["telemetry_dropped"],
               single_master_updates_per_s=single["updates_per_s"],
               single_master_steady_updates_per_s=single[
                   "steady_updates_per_s"])
    emit(rec)
    batches = sum(stats["coalesce_counts"].values())
    if (stats["shard_applied"] != [FREE_GRADS] * SHARDS
            or len(hist.gap) != FREE_GRADS
            or counts["flat_update_batch"] != batches):
        raise AssertionError(f"sharded_free: {stats['shard_applied']} "
                             f"applied, {len(hist.gap)} telemetry rows, "
                             f"{counts}, {batches} batches")
    return rec


def hot_ranges(spec):
    """Three row ranges of the MLP's layout: the first layer's block (its
    bias and weight), a middle range, the last rows."""
    first = -(-(DIMS[1] + DIMS[0] * DIMS[1]) // 128)
    mid = spec.rows // 2
    return {"first_layer": (0, first), "middle": (mid - 8192, mid + 8192),
            "last": (spec.rows - 4096, spec.rows)}


def pull_queue(events):
    """Where each rejoin pull sat in the master's queue, from a traced
    run: for every pull-only round trip (the worker's ``rpc`` span, which
    ends with the reply or with the run), the messages applied before it
    was enqueued, those applied while it waited, and its round-trip
    milliseconds."""
    applies = [(e["ts"], e["args"]["k"]) for e in events
               if e["ph"] == "X" and e["name"] == "apply"]
    out = []
    for e in events:
        if not (e["ph"] == "X" and e["name"] == "rpc"
                and e.get("args", {}).get("pull_only")):
            continue
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        out.append({"applied_before_enqueue": sum(
                        k for t, k in applies if t < t0),
                    "applied_while_queued": sum(
                        k for t, k in applies if t0 <= t < t1),
                    "rpc_ms": e["dur"] / 1e3})
    return out


def phase_hot_rows(card, conf):
    """send_view over three row ranges of the 64-worker slab, read in
    place (its pitch), against the full view's rows and the plain
    version, each device-timed beside the full view: dana-zero's
    view_rows (the v0 slab, N=1: bit for bit both) and the N=64
    weighted send (bit for bit the full call's rows; the plain version's
    tensordot within WEIGHTED_TOL); then a free run with declared
    hot_rows and a dropout, whose rejoin pulls are served over the hot
    rows."""
    from repro_torch.cluster import ClusterConfig, FaultPlan, run_cluster
    from repro_torch.core.flat import FlatSpec
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.flat_update import (FlatAlgorithm,
                                                 flat_send_view,
                                                 flat_send_view_ref)
    from repro_torch.obs import MetricsRegistry, trace
    t_phase = time.perf_counter()
    task, grad_fn, eval_fn, params0, algo = conf
    spec = FlatSpec.from_tree(params0)
    gen = torch.Generator(device="cuda").manual_seed(21)
    fa = FlatAlgorithm(algo)
    fa.spec = spec
    rows = spec.rows
    flat = {"theta": torch.randn((rows, 128), generator=gen, device="cuda"),
            "v": torch.randn((WORKERS, rows, 128), generator=gen,
                             device="cuda") * 0.1,
            "t": 5, "lr_prev": np.float32(LR), "vscale": np.float32(1.0)}
    flat["v0"] = flat["v"].sum(0)
    w = torch.rand(WORKERS, generator=gen, device="cuda") + 0.5
    c = np.float32(LR) * np.float32(0.9)
    full_v0 = fa._view_flat(flat, 3)
    full_w = flat_send_view(flat["theta"], flat["v"], w, c)
    rec = {"phase": "hot_rows", "R": rows, "N": WORKERS, "ranges": {},
           "full_view_device_ms_N1": device_ms(
               lambda: fa._view_flat(flat, 3), "send_view"),
           "full_view_device_ms_N64": device_ms(
               lambda: flat_send_view(flat["theta"], flat["v"], w, c),
               "send_view")}
    for label, (r0, r1) in hot_ranges(spec).items():
        n_rows = r1 - r0
        part = fa.view_rows(flat, 3, r0, r1)
        plain = flat_send_view_ref(flat["theta"][r0:r1],
                                   flat["v0"][None][:, r0:r1],
                                   torch.ones(1, device="cuda"),
                                   fa._send_scale(flat))
        strided = flat["v"][:, r0:r1]
        part_w = flat_send_view(flat["theta"][r0:r1], strided, w, c)
        plain_w = flat_send_view_ref(flat["theta"][r0:r1], strided, w, c)
        scale = flat_send_view_ref(flat["theta"][r0:r1].abs(),
                                   strided.abs(), w.abs(), -abs(c))
        torch.cuda.synchronize()
        r = {"rows": [r0, r1],
             "strided": not strided.is_contiguous(),
             "N1_bit_equal_to_full_view": bool(torch.equal(
                 part, full_v0[r0:r1])),
             "N1_bit_equal_to_plain": bool(torch.equal(part, plain)),
             "N64_bit_equal_to_full_view": bool(torch.equal(
                 part_w, full_w[r0:r1])),
             "N64_max_abs_err_vs_plain": max_err(
                 part_w, plain_w, WEIGHTED_TOL,
                 f"send_view rows {label}", scale),
             "device_ms_N1": device_ms(
                 lambda: fa.view_rows(flat, 3, r0, r1), "send_view"),
             "device_ms_N64": device_ms(
                 lambda: flat_send_view(flat["theta"][r0:r1], strided, w,
                                        c), "send_view")}
        for n, key in ((1, "N1"), (WORKERS, "N64")):
            nbytes = 4 * n_rows * 128 * (n + 2)
            r[f"bytes_{key}"] = nbytes
            r[f"bound_ms_{key}"], r[f"bound_by_{key}"] = card.bound(
                nbytes, n_rows * 128 * (2 * n + 2))
            r[f"device_share_of_bound_{key}"] = (r[f"bound_ms_{key}"]
                                                 / r[f"device_ms_{key}"])
        rec["ranges"][label] = r
        if not (r["strided"] and r["N1_bit_equal_to_full_view"]
                and r["N1_bit_equal_to_plain"]
                and r["N64_bit_equal_to_full_view"]):
            emit(rec)
            raise AssertionError(f"hot_rows {label}: {r}")
    del flat, full_v0, full_w
    torch.cuda.empty_cache()
    # a free run: workers 1-4 drop out and rejoin through hot-row pulls
    hot = [None] * WORKERS
    ranges = list(hot_ranges(spec).values())
    for wid in range(1, 5):
        hot[wid] = ranges[wid % len(ranges)]
    # offline from master step 1 to HOT_GRADS - 64: each of workers 1-4
    # sees the window at its second iteration, which starts after its
    # first reply (one of the first 64 messages), and rejoins with a
    # pull 64 messages before the end: the mailbox holds at most one
    # message of each of the other 63 workers, so the pull is drained
    # before the run ends
    cfg = ClusterConfig(num_workers=WORKERS, total_grads=HOT_GRADS,
                        mode="free", coalesce=8, eval_every=HOT_GRADS,
                        record_telemetry=False, device="cuda",
                        hot_rows=tuple(hot),
                        faults=FaultPlan(dropout=tuple(
                            (wid, 1, HOT_GRADS - 64) for wid in range(1, 5))))
    reg, stats = MetricsRegistry(), {}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    trace.enable()
    try:
        hist = run_cluster(algo, grad_fn, params0, task.batch, cfg,
                           eval_fn, stats_out=stats, metrics=reg)
    finally:
        trace.disable()
    torch.cuda.synchronize()
    counts = launches()
    snap = reg.snapshot()
    rec.update(seconds=time.perf_counter() - t0,
               phase_seconds=time.perf_counter() - t_phase,
               updates_per_s=stats["updates_per_s"], launches=counts,
               pulls=snap["pulls"]["value"],
               pull_rows=snap["pull_rows"]["value"],
               pull_queue=pull_queue(trace.export()["traceEvents"]),
               coalesce_counts=stats["coalesce_counts"],
               eval_loss=hist.eval_loss)
    emit(rec)
    if (stats["applied"] != HOT_GRADS or not np.isfinite(hist.eval_loss).all()
            or counts["flat_update_batch"]
            != sum(stats["coalesce_counts"].values())):
        raise AssertionError(f"hot_rows run: {stats['applied']} applied, "
                             f"{counts}")
    # the pulls were served over the hot rows, not the full view
    if not (rec["pulls"] >= 1 and 0 < rec["pull_rows"]
            < rec["pulls"] * rows):
        raise AssertionError(f"hot_rows run: {rec['pulls']} pulls served "
                             f"{rec['pull_rows']} rows")
    return rec


# -- the process backend ----------------------------------------------------
# The process phases run PROCS_WORKERS worker processes, not WORKERS: each
# child holds a CUDA context and spawning one costs seconds of imports on
# the host's cores (scripts/torch_profile_cluster.py --backend process
# measures the 64-worker run: its memory, its spawn time and its rate)
PROCS_WORKERS = 16
PROCS_REDUCED = {"workers": f"{WORKERS} -> {PROCS_WORKERS}",
                 "cause": "spawn seconds: 64 worker processes fit on the "
                          "card (78 GB) but take 108-128 s a run to spawn "
                          "on an 8-core host"}
PROCS_CAP = 2 * PROCS_WORKERS   # ring slots a shard (the JAX default)
PROCS_SHARDS = 2          # procs_pinned
PROCS_GRADS = 128         # procs_pinned, procs_ga
PROCS_FREE_SHARDS = (1, 2, 4)
PROCS_TOL = dict(rtol=1e-5, atol=1e-6)
PROCS_LM_WORKERS, PROCS_LM_GRADS = 2, 32


class MemSampler:
    """Samples, every ``interval`` seconds while a run is live, each
    process's device memory as nvidia-smi reports it
    (``--query-compute-apps``; empty where the card's process table is
    not this host's) and the card's used memory
    (``torch.cuda.mem_get_info``), keeping each one's maximum, and the
    card's utilization (nvidia-smi's share of its sample period with a
    kernel running, from any process)."""

    def __init__(self, interval=1.0):
        import threading
        self.interval = interval
        self.per_pid = {}
        self.device_used_max = 0
        self.utilization = []     # percent of each sample period busy
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _query(self, what):
        return subprocess.run(
            ["nvidia-smi", what, "--format=csv,noheader,nounits"],
            capture_output=True, text=True).stdout

    def _sample(self):
        for line in self._query(
                "--query-compute-apps=pid,used_memory").splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 2 and all(p.isdigit() for p in parts):
                pid, mib = int(parts[0]), int(parts[1])
                self.per_pid[pid] = max(self.per_pid.get(pid, 0), mib)
        free, total = torch.cuda.mem_get_info()
        self.device_used_max = max(self.device_used_max, total - free)
        util = self._query("--query-gpu=utilization.gpu").strip()
        if util.isdigit():
            self.utilization.append(int(util))

    def _loop(self):
        while not self._stop.wait(self.interval):
            self._sample()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def mps_daemon_running():
    """Whether an MPS control daemon runs on this host (a process named
    nvidia-cuda-mps-*); this script never starts one."""
    for comm in Path("/proc").glob("[0-9]*/comm"):
        try:
            if comm.read_text().startswith("nvidia-cuda-mps"):
                return True
        except OSError:
            continue
    return False


def procs_memory_plan(spec, shards_list, cap, evals, workers):
    """The reckoned device bytes of the process backend's terms at this
    width, before its first run: the dana-zero state (theta, a momentum
    row a worker, v0), the workers' view buffers, the ring (grad,
    telemetry view
    and reply slots), the eval snapshots, a worker's own tensors (its
    gradient's leaves; it packs them straight into the ring slots) and a
    shard's k=8 batch (reply views, telemetry pre-update views)."""
    slab = spec.rows * 128 * 4
    return {"phase": "procs_memory_plan", "rows": spec.rows,
            "workers": workers, "slab_bytes": slab,
            "state_bytes": (workers + 2) * slab,
            "worker_view_buffers_bytes": workers * slab,
            "ring_bytes": 3 * cap * slab, "mailbox_capacity": cap,
            "eval_snapshot_bytes": evals * slab,
            "worker_tensor_bytes_each": slab,
            "shard_batch_bytes": {S: 2 * 8 * slab // S
                                  for S in shards_list},
            "host_cores": os.cpu_count(),
            "mps_daemon_running": mps_daemon_running()}


def procs_conf(conf):
    """``conf`` with the MLP's gradient as a picklable object
    (``ClassifierGradFn``, the same function as ``configuration``'s
    closure): the process backend pickles it into every worker."""
    from repro_torch.models.toy import ClassifierGradFn
    return (conf[0], ClassifierGradFn(DIMS)) + tuple(conf[2:])


def run_procs(conf, **kw):
    """One ``run_cluster(backend="process")`` at full width with
    PROCS_WORKERS workers through ``run_cluster_once`` (the parent's
    launch counts set to 0 just before it and read just after; the
    children's counts start at 0 in each child and come back in
    ``stats["launches"]``), with the memory sampler on; returns
    (history, stats, record)."""
    with MemSampler() as mem:
        hist, stats, counts, secs, peak = run_cluster_once(
            conf, backend="process", mailbox_capacity=PROCS_CAP,
            workers=PROCS_WORKERS, **kw)
    cm = stats["child_memory"]
    rec = {"seconds": secs, "workers": PROCS_WORKERS,
           "reduced": PROCS_REDUCED,
           "updates_per_s": stats["updates_per_s"],
           "steady_updates_per_s": stats["steady_updates_per_s"],
           "wall_s": stats["wall_s"], "shards": stats["shards"],
           "shard_applied": stats["shard_applied"],
           "shard_busy_s": stats["shard_busy_s"],
           "shard_busy_share": [b / stats["wall_s"]
                                for b in stats["shard_busy_s"]],
           "coalesce_counts": stats["coalesce_counts"],
           "mean_coalesce": stats["mean_coalesce"],
           "spawn_s": stats["spawn_s"],
           "worker_seconds": stats["worker_seconds"],
           "ring_bytes": stats["ring_bytes"],
           "mailbox_capacity": stats["mailbox_capacity"],
           "launches_parent": {k: n for k, n in counts.items() if n},
           "launches_children": stats["launches"],
           "launches": {k: counts.get(k, 0) + stats["launches"].get(k, 0)
                        for k in set(counts) | set(stats["launches"])},
           "parent_peak_mem_gb": peak / 1e9,
           "device_used_max_gb": mem.device_used_max / 1e9,
           "card_utilization_samples": mem.utilization,
           "smi_mib_by_pid": {str(p): m for p, m in mem.per_pid.items()},
           "allocator_reserved_gb_shards": [
               b / 1e9 for b in cm["shards"].values()],
           "allocator_reserved_gb_workers_max": max(
               cm["workers"].values()) / 1e9,
           "host_cores": os.cpu_count(),
           "mps_daemon_running": mps_daemon_running(),
           "eval_step": hist.eval_step, "eval_loss": hist.eval_loss}
    if not (hist.eval_loss and all(np.isfinite(hist.eval_loss))):
        raise AssertionError(f"process run: eval losses {hist.eval_loss}")
    return hist, stats, rec


def phase_procs_pinned(conf):
    """dana-zero, PROCS_SHARDS shards, pin_schedule, PROCS_GRADS messages,
    PROCS_WORKERS workers, on the thread backend and then the process
    backend: final parameters bit for bit, identical worker/lag/step
    streams; the shard children launch flat_update_batch once a shard a
    message (the pin drains k=1), the parent send_view once a shard an
    initial view."""
    from repro_torch.core.flat import FlatSpec
    from repro_torch.core.types import tree_leaves
    conf = procs_conf(conf)
    emit(procs_memory_plan(FlatSpec.from_tree(conf[3]), PROCS_FREE_SHARDS,
                           PROCS_CAP, FREE_GRADS // EVAL_EVERY,
                           PROCS_WORKERS))
    kw = dict(mode="free", total_grads=PROCS_GRADS, pin_schedule=True,
              shards=PROCS_SHARDS, record_telemetry=True)
    ht, st, ct, secs_t, _ = run_cluster_once(conf, workers=PROCS_WORKERS,
                                             **kw)
    final_t = [l.clone() for l in tree_leaves(ht.final_params)]
    events_t = [getattr(ht, k) for k in ("worker", "lag", "step")]
    del ht
    hp, sp, rec = run_procs(conf, **kw)
    rec.update(phase="procs_pinned", thread_seconds=secs_t,
               thread_updates_per_s=st["updates_per_s"],
               thread_launches=ct)
    rec["final_params_bit_equal_to_thread"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(hp.final_params),
                                          final_t))
    rec["events_equal_to_thread"] = events_t == [
        getattr(hp, k) for k in ("worker", "lag", "step")]
    emit(rec)
    lc, lp = rec["launches_children"], rec["launches_parent"]
    if (lc.get("flat_update_batch") != PROCS_SHARDS * PROCS_GRADS
            or lp.get("send_view") != PROCS_SHARDS * PROCS_WORKERS
            or ct["flat_update_batch"] != PROCS_SHARDS * PROCS_GRADS):
        raise AssertionError(f"procs_pinned launches: children {lc}, "
                             f"parent {lp}, thread {ct}")
    if not (rec["final_params_bit_equal_to_thread"]
            and rec["events_equal_to_thread"]):
        raise AssertionError("procs_pinned differs from the thread "
                             "backend's pinned run")
    return rec


def phase_procs_ga(conf_ga):
    """ga-asgd, 1 shard, pin_schedule, PROCS_GRADS messages,
    PROCS_WORKERS workers: the process backend within PROCS_TOL of the
    thread backend; gap_update once a message in the shard child (k + 2
    kernels a drained batch)."""
    from repro_torch.core.types import tree_leaves
    conf_ga = procs_conf(conf_ga)
    kw = dict(mode="free", total_grads=PROCS_GRADS, pin_schedule=True,
              record_telemetry=True)
    ht, st, ct, secs_t, _ = run_cluster_once(conf_ga,
                                             workers=PROCS_WORKERS, **kw)
    final_t = [l.clone() for l in tree_leaves(ht.final_params)]
    worker_t = list(ht.worker)
    del ht
    hp, sp, rec = run_procs(conf_ga, **kw)
    final_p = tree_leaves(hp.final_params)
    rec.update(phase="procs_ga", thread_seconds=secs_t,
               thread_updates_per_s=st["updates_per_s"],
               thread_launches=ct, tolerance=PROCS_TOL,
               workers_equal_to_thread=list(hp.worker) == worker_t)
    rec["max_abs_err_vs_thread"] = max(
        max_err(a, b, PROCS_TOL, "procs_ga final parameters")
        for a, b in zip(final_p, final_t))
    rec["final_params_rel_l2_vs_thread"] = rel_l2(final_p, final_t)
    emit(rec)
    lc = rec["launches_children"]
    if (lc.get("gap_update") != PROCS_GRADS or lc.get("flat_update_batch")
            or ct["gap_update"] != PROCS_GRADS):
        raise AssertionError(f"procs_ga launches: children {lc}, thread "
                             f"{ct}")
    if not rec["workers_equal_to_thread"]:
        raise AssertionError("procs_ga: worker streams differ")
    return rec


def phase_procs_free(conf, single, sharded):
    """dana-zero, free, coalescing up to 8, FREE_GRADS messages,
    PROCS_WORKERS workers: the thread backend's single master, then
    the process backend at each S of PROCS_FREE_SHARDS, beside this
    call's cluster_free and sharded_free (WORKERS threads): updates/s,
    each shard's applied count and busy seconds, the drained k, spawn
    seconds, the workers' host seconds by loop part, memory; one
    flat_update_batch a shard a drained batch in the children, send_view
    S a worker in the parent."""
    conf = procs_conf(conf)
    kw = dict(mode="free", total_grads=FREE_GRADS, coalesce=8,
              record_telemetry=True)
    _, st, _, secs, _ = run_cluster_once(conf, workers=PROCS_WORKERS, **kw)
    thread = {"updates_per_s": st["updates_per_s"],
              "steady_updates_per_s": st["steady_updates_per_s"],
              "mean_coalesce": st["mean_coalesce"], "seconds": secs}
    recs = {}
    for S in PROCS_FREE_SHARDS:
        hist, stats, rec = run_procs(conf, shards=S, **kw)
        batches = sum(stats["coalesce_counts"].values())
        rec.update(phase=f"procs_free S={S}",
                   telemetry_rows=len(hist.gap),
                   telemetry_dropped=stats["telemetry_dropped"],
                   thread_same_workers_single=thread,
                   thread_single_updates_per_s=single["updates_per_s"],
                   thread_single_steady_updates_per_s=single[
                       "steady_updates_per_s"],
                   thread_sharded_updates_per_s=sharded["updates_per_s"],
                   thread_sharded_shards=sharded["shards"],
                   thread_workers=WORKERS)
        emit(rec)
        lc, lp = rec["launches_children"], rec["launches_parent"]
        if (stats["shard_applied"] != [FREE_GRADS] * S
                or len(hist.gap) != FREE_GRADS
                or lc.get("flat_update_batch") != batches
                or lp.get("send_view") != S * PROCS_WORKERS):
            raise AssertionError(f"procs_free S={S}: "
                                 f"{stats['shard_applied']} applied, "
                                 f"{len(hist.gap)} telemetry rows, "
                                 f"children {lc}, parent {lp}, {batches} "
                                 f"batches")
        recs[S] = rec
        del hist
    return recs

def offflat_run(name, dims, device, grads, workers=WORKERS, batch=BATCH):
    """run_simulation with an off-flat member: (history, seconds)."""
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.engine import SimulationConfig, run_simulation
    from repro_torch.core.types import HyperParams
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.models.toy import make_classifier_fns
    task = ClassificationTask(dim=dims[0], num_classes=dims[-1],
                              batch_size=batch, device=device)
    init, grad_fn, make_eval = make_classifier_fns(dims)
    params0 = init(np.random.default_rng(0), device=device)
    cfg = SimulationConfig(num_workers=workers, total_grads=grads,
                           eval_every=grads, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = run_simulation(make_algorithm(name, HyperParams(lr=LR,
                                                           momentum=0.9)),
                          grad_fn, params0, task.batch, cfg,
                          make_eval(task.eval_batch()))
    if device == "cuda":
        torch.cuda.synchronize()
    return hist, time.perf_counter() - t0


def phase_members_offflat():
    """ssgd (SSGD_ROUNDS rounds of WORKERS gradients), easgd, dana-easgd
    and yellowfin (OFFFLAT_GRADS messages each) through run_simulation at
    full width on the tree path (no kernel): every loss finite, ssgd's
    round count; then at OFFFLAT_CPU_DIMS with OFFFLAT_CPU_WORKERS
    workers, batches of OFFFLAT_CPU_BATCH and OFFFLAT_CPU_GRADS messages
    (ssgd: SSGD_ROUNDS rounds) the card's final parameters within
    OFFFLAT_CPU_TOL relative L2 of the same code on the CPU."""
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import launches, reset_launches
    recs = {}
    for name in OFFFLAT:
        t_phase = time.perf_counter()
        grads = SSGD_ROUNDS * WORKERS if name == "ssgd" else OFFFLAT_GRADS
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        hist, secs = offflat_run(name, DIMS, "cuda", grads)
        counts = launches()
        finite = (all(np.isfinite(hist.eval_loss))
                  and all(bool(torch.isfinite(l).all())
                          for l in tree_leaves(hist.final_params)))
        rec = {"phase": f"member {name}", "algorithm": name, "dims": DIMS,
               "workers": WORKERS, "grads": grads, "seconds": secs,
               "messages_per_s": grads / secs, "rows": len(hist.step),
               "eval_loss": hist.eval_loss, "launches": counts,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del hist
        torch.cuda.empty_cache()
        small = (SSGD_ROUNDS * OFFFLAT_CPU_WORKERS if name == "ssgd"
                 else OFFFLAT_CPU_GRADS)
        small_run = (OFFFLAT_CPU_DIMS, small, OFFFLAT_CPU_WORKERS,
                     OFFFLAT_CPU_BATCH)
        h_gpu, _ = offflat_run(name, small_run[0], "cuda", *small_run[1:])
        h_cpu, _ = offflat_run(name, small_run[0], "cpu", *small_run[1:])
        rec["width_256_rel_l2_card_vs_cpu"] = rel_l2(
            [l.cpu() for l in tree_leaves(h_gpu.final_params)],
            tree_leaves(h_cpu.final_params))
        rec["width_256_events_equal"] = all(
            getattr(h_gpu, k) == getattr(h_cpu, k)
            for k in ("time", "worker", "lag", "step"))
        rec["phase_seconds"] = time.perf_counter() - t_phase
        emit(rec)
        expect_rows = SSGD_ROUNDS if name == "ssgd" else grads
        if not finite or rec["rows"] != expect_rows or any(counts.values()):
            raise AssertionError(f"member {name}: finite {finite}, "
                                 f"{rec['rows']} rows, launches {counts}")
        if (rec["width_256_rel_l2_card_vs_cpu"] > OFFFLAT_CPU_TOL
                or not rec["width_256_events_equal"]):
            raise AssertionError(f"member {name}: the card and the CPU "
                                 f"disagree: {rec}")
        recs[name] = rec
    return recs


# -- mamba_scan ------------------------------------------------------------
def scan_inputs(b, s, d, n, seed, zero_h0=False):
    """Seeded inputs on the card, delta made positive by softplus as the
    JAX package's kernel test makes it."""
    from repro_torch.models.recurrent import softplus
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x, delta = randn(b, s, d), softplus(randn(b, s, d)) * 0.1
    bm, cm, a = randn(b, s, n), randn(b, s, n), -randn(d, n).abs()
    h0 = torch.zeros(b, d, n, device="cuda") if zero_h0 else randn(b, d, n)
    return x, delta, bm, cm, a, h0


def scan_proj_inputs(b, s, d, n, seed, dtype=torch.bfloat16, dt_rank=256,
                     zero_h0=False):
    """The scan's inputs as ``apply_mamba`` hands them over: xc in
    ``dtype``, B and C column slices of one (B, S, dt_rank + 2N)
    projection cut with ``torch.split`` (last axis contiguous, row stride
    dt_rank + 2N), delta, A and h0 float32."""
    x, dl, _, _, a, h0 = scan_inputs(b, s, d, n, seed, zero_h0)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    proj = torch.randn((b, s, dt_rank + 2 * n), generator=gen,
                       device="cuda").to(dtype)
    _, bm, cm = torch.split(proj, [dt_rank, n, n], dim=-1)
    return x.to(dtype), dl, bm, cm, a, h0


def scan_bytes_ops(b, s, d, n, xsize=4):
    """Each input read once, each output written once (x, delta, y; B, C;
    A; h0, last; x, B and C of ``xsize`` bytes, the rest float32), the
    f32 operations (6 per state element per step, 1 per channel per
    step) and the exponentials (1 per state element per step)."""
    nbytes = (xsize * (b * s * d + 2 * b * s * n)
              + 4 * (2 * b * s * d + d * n + 2 * b * d * n))
    return nbytes, 6 * b * s * d * n + b * s * d, b * s * d * n


def check_scan(card, label, b, s, d, n, seed, zero_h0=False, time_it=False,
               proj_dtype=None):
    """``proj_dtype``: xc in that dtype and B, C strided slices of a
    projection (``scan_proj_inputs``), as ``apply_mamba`` passes them."""
    from repro_torch.kernels.mamba_scan import mamba_scan_ref
    from repro_torch.kernels.mamba_scan.kernel import (layout_for,
                                                       mamba_scan_cuda)
    x, dl, bm, cm, a, h0 = (scan_inputs(b, s, d, n, seed, zero_h0)
                            if proj_dtype is None else
                            scan_proj_inputs(b, s, d, n, seed, proj_dtype,
                                             zero_h0=zero_h0))
    y, last = mamba_scan_cuda(x, dl, bm, cm, a, h0)
    ry, rlast = mamba_scan_ref(x, dl, bm, cm, a, h0)
    # |y_t| <= C_t . h_t with |x|, |B|, |C|, |h0| (exp(delta*A) > 0)
    scale = mamba_scan_ref(x.abs(), dl, bm.abs(), cm.abs(), a, h0.abs())[0]
    torch.cuda.synchronize()
    errs = {"y": max_err(y, ry, SCAN_TOL, f"mamba_scan {label} y", scale),
            "last": max_err(last, rlast, SCAN_TOL,
                            f"mamba_scan {label} last")}
    rec = {"phase": "mamba_scan", "mode": label, "B": b, "S": s, "D": d,
           "N": n, "h0": "zero" if zero_h0 else "random",
           "inputs": ("float32, contiguous" if proj_dtype is None else
                      f"{proj_dtype} xc, B and C split from a projection"),
           "layout": "step kernel, G=4" if s == 1 else
           "G={}, C={}".format(*layout_for(b, d)),
           "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
           "last_bit_equal": bool(torch.equal(last, rlast)),
           "tolerance": SCAN_TOL,
           "tolerance_reason": "y: the N-sum in another order, against the "
                               "sum of magnitudes"}
    if not rec["last_bit_equal"]:
        raise AssertionError(f"mamba_scan {label}: the last state is not "
                             f"bit-equal to the plain version's")
    if time_it:
        def call():
            return mamba_scan_cuda(x, dl, bm, cm, a, h0)
        rec["ms"] = time_ms(call)
        rec["device_ms"] = device_ms(call, "mamba_scan")
        rec["plain_ms"] = time_ms(lambda: mamba_scan_ref(x, dl, bm, cm, a,
                                                         h0))
        nbytes, nops, nexp = scan_bytes_ops(b, s, d, n, x.element_size())
        rec.update(bytes=nbytes, exps=nexp, library_ms=None,
                   bound_bytes_ms=nbytes / card.bw * 1e3,
                   bound_f32_ms=nops / card.f32 * 1e3,
                   bound_exp_ms=nexp / card.exp_rate * 1e3)
        rec["bound_ms"], rec["bound_by"] = card.bound(nbytes, nops, nexp)
    emit(rec)
    return rec


def check_scan_chained(b, s, d, n, split, seed):
    """Two kernel calls chained through the last state against one."""
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
    x, dl, bm, cm, a, h0 = scan_inputs(b, s, d, n, seed)
    y, last = mamba_scan_cuda(x, dl, bm, cm, a, h0)

    def part(t, lo, hi):
        return t[:, lo:hi].contiguous()

    y1, mid = mamba_scan_cuda(*(part(t, 0, split) for t in (x, dl, bm, cm)),
                              a, h0)
    y2, last2 = mamba_scan_cuda(*(part(t, split, s) for t in (x, dl, bm, cm)),
                                a, mid)
    yc = torch.cat([y1, y2], 1)
    torch.cuda.synchronize()
    rec = {"phase": "mamba_scan", "mode": f"chained at t={split}", "B": b,
           "S": s, "D": d, "N": n,
           "max_abs_err": max(max_err(yc, y, SCAN_TOL, "chained y"),
                              max_err(last2, last, SCAN_TOL, "chained last")),
           "bit_equal_to_one_call": bool(torch.equal(yc, y)
                                         and torch.equal(last2, last)),
           "tolerance": SCAN_TOL}
    emit(rec)
    return rec


def phase_mamba_scan(card):
    """Timed: the prefill shape (its h0 is zero), the Engine's one-request
    prefill at its largest bucket on the inputs the Engine gives it (bf16
    xc, B and C split from a bf16 projection) and a decode step.
    Checked: an odd S
    with a nonzero h0, N=8 and a D that is no multiple of the block, D
    not a multiple of 8 (plain staging), bf16 xc with B and C split from
    a bf16 projection at prefill and decode, a chained pair."""
    recs = {"main": check_scan(card, "prefill B=4 S=512 D=8192 N=16 "
                               "(serve_generate)", SERVE_BATCH, SERVE_PROMPT,
                               8192, 16, 41, zero_h0=True, time_it=True)}
    torch.cuda.empty_cache()
    recs["engine"] = check_scan(card, "Engine prefill B=1 S=256 (largest "
                                "bucket, serve_engine)", 1, 256, 8192, 16,
                                46, zero_h0=True, time_it=True,
                                proj_dtype=torch.bfloat16)
    recs["decode"] = check_scan(card, "decode S=1", SERVE_BATCH, 1, 8192, 16,
                                42, time_it=True)
    check_scan(card, "odd S=77, nonzero h0", SERVE_BATCH, 77, 8192, 16, 43)
    check_scan(card, "N=8, D=1000 (masked edge)", 2, 100, 1000, 8, 44)
    check_scan(card, "D=1002 (plain staging), S=40", 2, 40, 1002, 16, 47)
    recs["bf16_prefill"] = check_scan(
        card, "bf16 xc, B and C split from a bf16 projection, prefill",
        SERVE_BATCH, SERVE_PROMPT, 8192, 16, 48, zero_h0=True,
        proj_dtype=torch.bfloat16)
    recs["bf16_decode"] = check_scan(
        card, "bf16 xc, B and C split from a bf16 projection, decode",
        SERVE_BATCH, 1, 8192, 16, 49, proj_dtype=torch.bfloat16)
    check_scan_chained(SERVE_BATCH, SERVE_PROMPT, 8192, 16, 200, 45)
    torch.cuda.empty_cache()
    return recs


# -- rglru_scan ---------------------------------------------------------------
def rglru_inputs(b, s, d, seed, zero_h0=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, s, d), device="cuda", generator=g))
    x = torch.randn((b, s, d), device="cuda", generator=g)
    h0 = (torch.zeros((b, d), device="cuda") if zero_h0 else
          torch.randn((b, d), device="cuda", generator=g))
    return a, x, h0


def check_rglru(card, label, b, s, d, seed, zero_h0=False, time_it=False):
    """Kernel against the plain version, bit for bit (the product and the
    sum round separately on both sides).  Timed: the call (at S=1 in
    turns with torch.addcmul, the one PyTorch call that computes a step),
    its device time and its bound."""
    from repro_torch.kernels.rglru_scan import rglru_scan_ref
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    a, x, h0 = rglru_inputs(b, s, d, seed, zero_h0)
    out, last = rglru_scan_cuda(a, x, h0)
    rout, rlast = rglru_scan_ref(a, x, h0)
    torch.cuda.synchronize()
    rec = {"phase": "rglru_scan", "mode": label, "B": b, "S": s, "D": d,
           "h0": "zero" if zero_h0 else "random",
           "max_abs_err": max(max_err(out, rout, EXACT, f"rglru {label} h"),
                              max_err(last, rlast, EXACT,
                                      f"rglru {label} last")),
           "bit_equal": bool(torch.equal(out, rout)
                             and torch.equal(last, rlast)),
           "tolerance": EXACT}
    if time_it:
        def call():
            return rglru_scan_cuda(a, x, h0)
        rec["library_ms"] = None
        if s == 1:
            hv = h0[:, None]

            def addcmul():
                return torch.addcmul(x, a, hv)
            rec["ms"], rec["library_ms"] = time_pair(call, addcmul)
            rec["library"] = "torch.addcmul(x, a, h), in turns"
            rec["library_device_ms"] = device_ms(addcmul, "")
        else:
            rec["ms"] = time_ms(call)
        rec["device_ms"] = device_ms(call, "rglru")
        rec["plain_ms"] = time_ms(lambda: rglru_scan_ref(a, x, h0))
        nbytes, nops = 4 * (3 * b * s * d + 2 * b * d), 2 * b * s * d
        rec.update(bytes=nbytes, flops=nops)
        rec["bound_ms"], rec["bound_by"] = card.bound(nbytes, nops)
        rec["device_share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
    emit(rec)
    return rec


def check_rglru_chained(b, s, d, split, seed):
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    a, x, h0 = rglru_inputs(b, s, d, seed)
    out, last = rglru_scan_cuda(a, x, h0)
    o1, mid = rglru_scan_cuda(a[:, :split].contiguous(),
                              x[:, :split].contiguous(), h0)
    o2, last2 = rglru_scan_cuda(a[:, split:].contiguous(),
                                x[:, split:].contiguous(), mid)
    oc = torch.cat([o1, o2], 1)
    torch.cuda.synchronize()
    rec = {"phase": "rglru_scan", "mode": f"chained at t={split}", "B": b,
           "S": s, "D": d,
           "max_abs_err": max(max_err(oc, out, EXACT, "chained h"),
                              max_err(last2, last, EXACT, "chained last")),
           "bit_equal_to_one_call": bool(torch.equal(oc, out)
                                         and torch.equal(last2, last)),
           "tolerance": EXACT}
    emit(rec)
    return rec


def phase_rglru_scan(card):
    """Timed: recurrentgemma-9b's prefill shape and the long prompt (zero
    h0, as the model's prefill) and a decode step.  Checked bit for bit:
    S shorter than a stage (16 timesteps) with D not a multiple of 4 (one
    float a lane staged), an odd S with a D that is no multiple of the
    32-channel tile and a nonzero h0, a decode step with D not a multiple
    of 4, a chained pair split inside a stage."""
    recs = {"main": check_rglru(card, "prefill B=4 S=512 D=4096 "
                                "(serve_generate_rg)", SERVE_BATCH,
                                SERVE_PROMPT, 4096, 51, zero_h0=True,
                                time_it=True),
            "long": check_rglru(card, "long prompt B=1 S=3072 D=4096 "
                                "(serve_generate_rg_long)", RG_LONG_BATCH,
                                RG_LONG_PROMPT, 4096, 55, zero_h0=True,
                                time_it=True),
            "decode": check_rglru(card, "decode S=1", SERVE_BATCH, 1, 4096,
                                  52, time_it=True)}
    check_rglru(card, "odd S=77, D=1000 (masked edge), nonzero h0",
                SERVE_BATCH, 77, 1000, 53)
    check_rglru(card, "S=5 (shorter than a stage), D=1002 (one float a "
                "lane)", 2, 5, 1002, 56)
    check_rglru(card, "decode S=1, D=1001 (one float a thread)", 3, 1,
                1001, 57)
    check_rglru_chained(SERVE_BATCH, SERVE_PROMPT, 4096, 200, 54)
    torch.cuda.empty_cache()
    return recs


# -- swa_attention ------------------------------------------------------------
def band_pairs(s, window):
    """(query, key) pairs with i - window < j <= i."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def check_swa(card, label, b, s, h, kh, hd, window, dtype, seed,
              time_it=False):
    """Kernel against the plain version (K/V repeated over each group, as
    the plain path repeats them) with the JAX package's tolerance; timed:
    beside it the plain version and SDPA with the band as a boolean
    mask."""
    from repro_torch.kernels.swa_attention import swa_attention_gqa
    from repro_torch.kernels.swa_attention.kernel import swa_attention_cuda
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype)
               for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))

    def plain():
        return swa_attention_gqa(q, k, v, window)

    out = swa_attention_cuda(q, k, v, window)
    ref = plain()
    torch.cuda.synchronize()
    tol = SWA_TOL[dtype]
    rec = {"phase": "swa_attention", "mode": label, "B": b, "S": s, "H": h,
           "K": kh, "hd": hd, "window": window,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max_err(out.float(), ref.float(), tol,
                                  f"swa_attention {label}"),
           "tolerance": tol, "pairs": band_pairs(s, window),
           "causal_pairs": s * (s + 1) // 2}
    if time_it:
        rec["ms"] = time_ms(lambda: swa_attention_cuda(q, k, v, window))
        rec["plain_ms"] = time_ms(plain)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[:, None] - pos[None, :] < window)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if kh != h:
            kt, vt = (t.expand(b, h, s, hd) for t in (kt, vt))
        lib = sdpa(qt, kt, vt, attn_mask=mask).transpose(1, 2)
        torch.cuda.synchronize()
        rec["library_max_abs_err"] = float((lib.float() - ref.float())
                                           .abs().max())
        rec["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
        rec["library"] = ("torch.nn.functional.scaled_dot_product_attention"
                          " with the band as a boolean mask")
        es = q.element_size()
        nbytes = es * (2 * b * s * h * hd + 2 * b * s * kh * hd)
        nops = 4 * b * h * hd * rec["pairs"]
        rate = card.bf16 if dtype == torch.bfloat16 else card.f32
        tb, to = nbytes / card.bw * 1e3, nops / rate * 1e3
        rec.update(bytes=nbytes, flops=nops, bound_bytes_ms=tb,
                   bound_ops_ms=to, ops_rate=rate,
                   bound_ms=max(tb, to),
                   bound_by="bytes" if tb >= to else "operations",
                   device_ms=device_ms(
                       lambda: swa_attention_cuda(q, k, v, window),
                       "swa_attention"),
                   tflops=nops / rec["ms"] / 1e9)
        rec["device_tflops"] = nops / rec["device_ms"] / 1e9
    emit(rec)
    return rec


def phase_swa_attention(card):
    """recurrentgemma-9b's prefill (B=4, S=512, MQA, hd 256, window 2048
    >= S) and its long prompt (B=1, S=3072, window 2048: a band narrower
    than the sequence), bf16 (the model's type) timed and f32 checked; a
    small odd case (S=1000, window 128, hd 64, K=H) in both types."""
    recs = {}
    for key, b, s in (("main", SERVE_BATCH, SERVE_PROMPT),
                      ("long", RG_LONG_BATCH, RG_LONG_PROMPT)):
        recs[key] = check_swa(card, f"B={b} S={s} H=16 K=1 hd=256 w=2048",
                              b, s, 16, 1, 256, 2048, torch.bfloat16, 61,
                              time_it=True)
        check_swa(card, f"B={b} S={s} H=16 K=1 hd=256 w=2048", b, s, 16, 1,
                  256, 2048, torch.float32, 62)
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        check_swa(card, "odd S=1000 w=128 hd=64 K=H", 2, 1000, 4, 4, 64, 128,
                  dtype, 63)
    return recs


# -- lm_grad: gradients through the kernels ----------------------------------
# the reduced models' gradients on the card (kernel forwards, the plain
# versions' gradients backward) against the CPU's (plain versions
# throughout), leaf by leaf: relative L2 within 1e-4 (cuBLAS sums the
# products in another order than the CPU)
LM_GRAD = {"falcon-mamba-7b-reduced": (2, 64),      # (batch, tokens)
           "recurrentgemma-9b-reduced": (2, 160),   # past its window 64
           "qwen2-1.5b-reduced": (2, 128)}          # attn: window = S
LM_GRAD_TOL = 1e-4


def lm_grads(model, params0, tokens, w, device):
    """Leaf gradients of sum(logits * W) on ``device``."""
    from repro_torch.core.types import tree_leaves, tree_map
    params = tree_map(lambda l: l.detach().to(device).requires_grad_(True),
                      params0)
    logits, _ = model.forward(params, {"tokens": tokens.to(device)})
    (logits * w.to(device)).sum().backward()
    return [l.grad for l in tree_leaves(params)], logits.detach()


def phase_lm_grad():
    """Each reduced model in float32: parameters drawn once on the CPU
    from a seeded generator, tokens and W from numpy; the card's forward
    and backward with the launch counts set to 0 just before, then the
    CPU's.  Every leaf's gradient must be finite and within LM_GRAD_TOL
    (relative L2) of the CPU's; each kernel launched once a prologue
    layer and twice a unit layer (the forward checkpoints each unit
    repeat: the forward and the backward's recompute)."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.api import build_model
    for arch, (batch, seq) in LM_GRAD.items():
        cfg = get_config(arch)
        model = build_model(cfg, torch.float32)
        params0 = model.init(torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(4)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              size=(batch, seq)),
                                 dtype=torch.int32)
        w = torch.as_tensor(rng.standard_normal(
            (batch, seq, cfg.vocab_size)).astype(np.float32))
        reset_launches()
        t0 = time.perf_counter()
        g_card, logits_card = lm_grads(model, params0, tokens, w, "cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launches()
        g_cpu, logits_cpu = lm_grads(model, params0, tokens, w, "cpu")
        rel = []
        for a, b in zip(g_card, g_cpu):
            if a is None or b is None or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"lm_grad {arch}: a leaf has no finite "
                                     f"gradient on the card")
            rel.append(float((a.cpu() - b).norm() / b.norm()))
        logit_rel = float((logits_card.cpu() - logits_cpu).norm()
                          / logits_cpu.norm())
        expected = kernel_counts(cfg, 1)
        rec = {"phase": "lm_grad", "arch": arch, "dtype": "float32",
               "batch": batch, "tokens": seq, "leaves": len(rel),
               "params": sum(l.numel() for l in tree_leaves(params0)),
               "card_seconds": secs,
               "launches": {k: n for k, n in counts.items() if n},
               **{f"expected_{k}_launches": n for k, n in expected.items()},
               "logits_rel_l2": logit_rel, "grad_rel_l2_max": max(rel),
               "grad_rel_l2_median": float(np.median(rel)),
               "tolerance_rel_l2": LM_GRAD_TOL}
        emit(rec)
        check_counts(f"lm_grad {arch}", counts, expected)
        if max(rel) > LM_GRAD_TOL:
            raise AssertionError(f"lm_grad {arch}: a leaf's gradient is "
                                 f"{max(rel)} (relative L2) from the CPU's")


# -- recurrentgemma-9b serving -------------------------------------------------
def rg_generate_expect(gen):
    def expect(cfg):
        kinds = list(cfg.pattern_prologue) + \
            list(cfg.pattern_unit) * cfg.unit_repeats
        return {"rglru_scan": kinds.count("rec") * gen,
                "swa_attention": kinds.count("attn_local")}
    return expect


def rg_engine_expect(cfg, requests, steps):
    kinds = list(cfg.pattern_prologue) + \
        list(cfg.pattern_unit) * cfg.unit_repeats
    return {"rglru_scan": kinds.count("rec") * (requests + steps),
            "swa_attention": kinds.count("attn_local") * requests}


# -- falcon-mamba-7b serving -------------------------------------------------
def serve_model(arch=SERVE_ARCH):
    """``arch`` (falcon-mamba-7b by default) at full width and depth, bf16
    weights drawn on the card from a seeded generator, one layer at a
    time."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves
    from repro_torch.models.api import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    info = {"init_s": time.perf_counter() - t0,
            "params": sum(l.numel() for l in tree_leaves(params)),
            "param_gb": sum(l.numel() * l.element_size()
                            for l in tree_leaves(params)) / 1e9}
    return model, params, info


def serve_prompts(cfg, seed=0, batch=SERVE_BATCH, prompt=SERVE_PROMPT):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        size=(batch, prompt)),
                           dtype=torch.int32, device="cuda")


def check_counts(phase, counts, expect):
    """Every kernel of the path launched exactly as expected."""
    for name, n in expect.items():
        if counts[name] != n:
            raise AssertionError(f"{phase} launched {name} {counts[name]} "
                                 f"times, expected {n}")


def generate_phase(model, params, info, phase, batch, prompt, gen, expect,
                   seed=0):
    """``generate`` once with the counts set to 0 (after a short warm-up
    call: cuBLAS handles, the allocator), then prefill + one decode step
    against forward over prompt + token.  ``expect(cfg)`` gives each
    kernel's launch count."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models.attention import CacheSpec
    cfg = model.cfg
    prompts = serve_prompts(cfg, seed, batch, prompt)
    generate(model, params, prompts[:, :64], 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    toks, stats = generate(model, params, prompts, gen)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    expected = expect(cfg)
    spec = CacheSpec(prompt + 1, None)
    logits, cache = model.prefill(params, {"tokens": prompts}, spec)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    step, cache = model.decode_step(params, tok, cache, spec)
    ring = {}
    if "attn_local" in cfg.pattern_unit:        # the last local layer's ring
        pos = cache["unit"][cfg.pattern_unit.index("attn_local")]["pos"][-1]
        ring = {"ring_capacity": int(pos.shape[-1]),
                "ring_slot_of_first_decode": int(
                    torch.nonzero(pos == prompt)[0, 0]),
                "ring_oldest_position": int(pos[pos >= 0].min())}
        if ring["ring_slot_of_first_decode"] != prompt % pos.shape[-1]:
            raise AssertionError(f"{phase}: decode wrote ring slot "
                                 f"{ring['ring_slot_of_first_decode']}")
    del cache
    full, _ = model.forward(params, {"tokens": torch.cat([prompts, tok], 1)})
    full = full[:, -1].float()
    step = step[:, 0].float()
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in (logits, step, full))
    rec = {"phase": phase, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
           "vocab": cfg.vocab_size, "dtype": "bfloat16",
           "batch": batch, "prompt": prompt, "gen": gen,
           **info, **stats, "peak_mem_gb": peak / 1e9, "launches": counts,
           **{f"expected_{k}_launches": v for k, v in expected.items()},
           "first_tokens_equal_generate": bool(torch.equal(tok[:, 0],
                                                           toks[:, 0])),
           **ring,
           "decode_vs_forward_max_abs_err": float((step - full).abs().max()),
           "logit_abs_max": float(full.abs().max()), "finite": finite,
           "tolerance": SERVE_TOL, "first_sequence": toks[0].tolist()}
    emit(rec)
    check_counts(phase, counts, expected)
    if toks.shape != (batch, gen) or not finite:
        raise AssertionError(f"{phase}: wrong token shape or non-finite "
                             f"logits")
    if not rec["first_tokens_equal_generate"]:
        raise AssertionError(f"{phase}: prefill differs from generate")
    max_err(step, full, SERVE_TOL, f"{phase} decode vs forward")
    return rec


def phase_serve_generate(model, params, info):
    return generate_phase(
        model, params, info, "serve_generate", SERVE_BATCH, SERVE_PROMPT,
        SERVE_GEN, lambda cfg: {"mamba_scan": cfg.num_layers * SERVE_GEN})


def _margin_top2(row):
    top = torch.topk(row.float(), 2).values
    return float(top[0] - top[1])


def phase_serve_engine(model, params, phase="serve_engine",
                       expect=lambda cfg, requests, steps: {
                           "mamba_scan": cfg.num_layers * (requests
                                                           + steps)}):
    """The Engine over 8 seeded requests with the counts set to 0; then
    each request's first two tokens against a lone prefill (and decode)
    of its left-padded bucket, where the top-2 margin is above the bf16
    tolerance.  ``expect`` gives each kernel's launch count from the
    requests admitted and the engine steps."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serve import Engine, Request
    cfg = model.cfg
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(20, 251))).astype(np.int32),
        max_new=int(rng.integers(8, 25))) for i in range(ENGINE_REQUESTS)]
    eng = Engine(model, params, slots=ENGINE_SLOTS, capacity=ENGINE_CAPACITY)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    steps = 0
    slot_of = {}                   # request -> the slot it was served in
    while (eng.queue or eng.active_mask.any()) and steps < 1000:
        eng.step()
        steps += 1
        slot_of.update({r.rid: s for s, r in enumerate(eng.active) if r})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    expected = expect(cfg, ENGINE_REQUESTS, steps)
    compared = agreed = 0
    for r in reqs:
        plen = next(b for b in eng.buckets if len(r.prompt) <= b)
        toks = np.zeros((1, plen), np.int32)
        toks[0, -len(r.prompt):] = r.prompt
        logits, cache = model.prefill(
            params, {"tokens": torch.as_tensor(toks, device="cuda")},
            eng.spec)
        step, _ = model.decode_step(
            params, torch.tensor([[r.output[0]]], dtype=torch.int32,
                                 device="cuda"), cache, eng.spec)
        for row, got in ((logits[0, -1], r.output[0]),
                         (step[0, -1], r.output[1])):
            if _margin_top2(row) > SERVE_TOL["atol"]:
                compared += 1
                agreed += int(torch.argmax(row)) == got
    rec = {"phase": phase, "arch": cfg.name, "slots": ENGINE_SLOTS,
           "capacity": ENGINE_CAPACITY, "buckets": list(eng.buckets),
           "requests": ENGINE_REQUESTS,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "max_new": [r.max_new for r in reqs], "steps": steps,
           "slot_of_request": [slot_of.get(r.rid) for r in reqs],
           "seconds": secs, **eng.stats(), "launches": counts,
           **{f"expected_{k}_launches": v for k, v in expected.items()},
           "tokens_compared_with_lone_path": compared,
           "tokens_agreeing": agreed,
           "margin_threshold": SERVE_TOL["atol"]}
    emit(rec)
    done = {r.rid for r in eng.done}
    if done != set(range(ENGINE_REQUESTS)) or any(
            len(r.output) != r.max_new for r in reqs):
        raise AssertionError(f"{phase}: not every request finished with "
                             f"its max_new tokens")
    if len(slot_of) != ENGINE_REQUESTS or \
            len(set(slot_of.values())) != ENGINE_SLOTS:
        raise AssertionError(f"{phase}: slots not reused: {slot_of}")
    check_counts(phase, counts, expected)
    if compared == 0 or agreed != compared:
        raise AssertionError(f"{phase}: {agreed} of {compared} tokens agree "
                             f"with the lone path")
    return rec


# -- the LM training path ------------------------------------------------------
# qwen2-1.5b (configs/qwen2_1_5b.py, arXiv:2407.10671) at full width and
# depth through launch.train.main: DANA's pod round, 2 pods, bf16 compute,
# f32 state; every attn layer through swa_attention with window = S.
# Each unit repeat is checkpointed, so every kernel launches twice a layer
# a pod a step (the forward and the backward's recompute).
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_PODS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8, 512, 6
TRAIN_CKPT_EVERY = 3
# full width, depth cut: recurrentgemma-9b to one pattern unit (rec, rec,
# attn_local) without its 2-layer prologue, falcon-mamba-7b to 2 layers
TRAIN_CUTS = {"recurrentgemma-9b": dict(num_layers=3, pattern_prologue=(),
                                        unit_repeats=0),
              "falcon-mamba-7b": dict(num_layers=2, unit_repeats=0)}
TRAIN_CUT_BATCH, TRAIN_CUT_SEQ, TRAIN_CUT_STEPS = 2, 512, 2
# the cluster's --preset lm: qwen2-1.5b reduced with the tiny-LM overrides
CLUSTER_LM_WORKERS, CLUSTER_LM_GRADS = 4, 64
# one deterministic pass at full width, depth cut to 2 layers
CLUSTER_LM_FULL_CUT = dict(num_layers=2, unit_repeats=0)
CLUSTER_LM_FULL_GRADS = 16
CLUSTER_LM_FULL_BATCH = 8


KERNEL_OF_KIND = {"mamba": "mamba_scan", "rec": "rglru_scan",
                  "attn": "swa_attention", "attn_local": "swa_attention"}


def kernel_counts(cfg, passes):
    """Launches of each scan and attention kernel for ``passes`` forward
    and backward passes: once a prologue layer and twice a unit layer a
    pass (each unit repeat is checkpointed: the forward and the
    backward's recompute)."""
    counts = {}
    for kinds, per_layer in ((cfg.pattern_prologue, 1),
                             (cfg.pattern_unit * cfg.unit_repeats, 2)):
        for kind in kinds:
            name = KERNEL_OF_KIND.get(kind)
            if name:
                counts[name] = counts.get(name, 0) + per_layer * passes
    return counts


def state_checksums(state):
    """Two int64 sums of every leaf's 32-bit patterns (plain, and weighted
    by position mod 4093) on the card: equal states give equal sums."""
    from repro_torch.core.types import tree_leaves
    out = []
    for leaf in tree_leaves(state):
        bits = leaf.reshape(-1).view(torch.int32)
        plain = weighted = 0
        for i in range(0, bits.numel(), 1 << 26):
            chunk = bits[i:i + (1 << 26)].long()
            w = (torch.arange(i, i + chunk.numel(), device=chunk.device)
                 % 4093) + 1
            plain += int(chunk.sum())
            weighted += int((chunk * w).sum())
        out.append((plain, weighted))
    return out


def train_record(phase, cfg, steps, counts, secs, batch, seq, peak):
    """s/step (the median of the steps after the first), tok/s, peak
    memory, the first and last loss."""
    losses = [l for l, _ in steps]
    per_step = float(np.median([t for _, t in steps[1:]])) if \
        len(steps) > 1 else steps[0][1]
    return {"phase": phase, "arch": cfg.name, "d_model": cfg.d_model,
            "num_layers": cfg.num_layers, "batch": batch, "seq": seq,
            "steps": len(steps), "losses": losses,
            "first_loss": losses[0], "last_loss": losses[-1],
            "step_seconds": [t for _, t in steps],
            "s_per_step": per_step, "tok_per_s": batch * seq / per_step,
            "seconds": secs, "peak_mem_gb": peak / 1e9,
            "launches": {k: n for k, n in counts.items() if n}}


class _Stop(Exception):
    """Raised by phase_train_qwen2's step wrapper to end a run of
    launch.train.main after its last step, before its last save."""


def phase_train_qwen2():
    """launch.train.main on qwen2-1.5b at full width and depth, 2 pods,
    batch 8 (4 a pod), 512 tokens, 6 steps, a checkpoint every 3 steps;
    then the same command again, which resumes from the step-3
    checkpoint.  Each run is ended right after its step 6, before the
    step-6 save, so the script writes one 28.4 GB train state (its disk
    writes stay under 45 GB): the first run writes the step-3
    checkpoint, the second reads it.  Each step's loss and the final state are read through a
    wrapper around ``build_train_step`` (the CLI itself unchanged).
    Checks: finite losses, v0 == sum_p v_p bit for bit, the
    swa_attention launches, and the resumed steps 4-6 equal to the first
    run's bit for bit (losses, and the final states' checksums)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import train as train_mod
    cfg = get_config(TRAIN_ARCH)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = ["--arch", TRAIN_ARCH, "--pods", str(TRAIN_PODS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--log-every", "1", "--ckpt", str(ckpt)]
    real = train_mod.build_train_step
    steps, last = [], {}

    def recording(*a, **kw):
        step = real(*a, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            steps.append((float(metrics["loss"]), time.perf_counter() - t0))
            if int(state["t"]) == TRAIN_STEPS:
                last["state"] = state
                raise _Stop
            return state, metrics
        return timed

    def run():
        steps.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        try:
            train_mod.main(args)
        except _Stop:
            pass
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, launches(),
                torch.cuda.max_memory_allocated(), last.pop("state"),
                list(steps))

    train_mod.build_train_step = recording
    try:
        secs, counts, peak, state, first = run()
        rec = train_record("train_qwen2", cfg, first, counts, secs,
                           TRAIN_BATCH, TRAIN_SEQ, peak)
        theta = tree_leaves(state["theta"])
        rec.update(pods=TRAIN_PODS, compute="bfloat16", state="float32",
                   params=sum(l.numel() for l in theta),
                   state_gb=sum(l.numel() * l.element_size()
                                for l in tree_leaves(state)) / 1e9,
                   expected_launches=kernel_counts(cfg, TRAIN_PODS
                                                   * TRAIN_STEPS))
        rec["v0_is_sum_of_pod_momenta_bit_for_bit"] = all(
            torch.equal(torch.sum(v, dim=0), v0) for v, v0 in zip(
                tree_leaves(state["v"]), tree_leaves(state["v0"])))
        finite = all(np.isfinite(l) for l, _ in first) and all(
            bool(torch.isfinite(l).all()) for l in theta)
        sums = state_checksums(state)
        del state, theta
        saved = sorted(p.name for p in ckpt.glob("step_*.npz"))
        rec["checkpoints"] = saved
        rec["checkpoint_gb"] = (ckpt / saved[-1]).stat().st_size / 1e9
        secs2, counts2, peak2, state2, resumed = run()
        sums2 = state_checksums(state2)
        del state2
        gap = max(abs(a - b) / abs(b) for (a, _), (b, _) in
                  zip(resumed, first[TRAIN_CKPT_EVERY:]))
        rec.update(resume_seconds=secs2, resume_losses=[l for l, _ in
                                                        resumed],
                   resume_step_seconds=[t for _, t in resumed],
                   resume_launches={k: n for k, n in counts2.items() if n},
                   resume_peak_mem_gb=peak2 / 1e9,
                   resume_losses_bit_equal=[l for l, _ in resumed]
                   == [l for l, _ in first[TRAIN_CKPT_EVERY:]],
                   resume_loss_max_rel_gap=gap,
                   resume_state_checksums_equal=sums2 == sums)
    finally:
        train_mod.build_train_step = real
        shutil.rmtree(ckpt, ignore_errors=True)
    emit(rec)
    if not finite:
        raise AssertionError("train_qwen2: non-finite losses or parameters")
    if not rec["v0_is_sum_of_pod_momenta_bit_for_bit"]:
        raise AssertionError("train_qwen2: v0 is not the sum of the pods' "
                             "momenta")
    if saved != [f"step_{TRAIN_CKPT_EVERY:07d}.npz"]:
        raise AssertionError(f"train_qwen2: checkpoints {saved}")
    check_counts("train_qwen2", counts, rec["expected_launches"])
    check_counts("train_qwen2 resumed", counts2, kernel_counts(
        cfg, TRAIN_PODS * (TRAIN_STEPS - TRAIN_CKPT_EVERY)))
    if len(resumed) != TRAIN_STEPS - TRAIN_CKPT_EVERY or \
            not rec["resume_losses_bit_equal"] or \
            not rec["resume_state_checksums_equal"]:
        raise AssertionError(f"train_qwen2: the resumed run is not the "
                             f"first run's bit for bit: losses apart by "
                             f"{gap} (relative), state checksums equal "
                             f"{rec['resume_state_checksums_equal']}")
    return rec


def phase_train_cut(arch):
    """build_train_step on ``arch`` at full width, depth cut
    (TRAIN_CUTS), 1 pod, batch 2, 512 tokens, 2 steps: finite losses and
    each kernel of the model launched twice a layer a step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import LMTask
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.steps import (TrainSettings, build_train_step,
                                          init_train_state)
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_config(arch), **TRAIN_CUTS[arch])
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, torch.Generator(
        device="cuda").manual_seed(0), 1, "cuda")
    task = LMTask(vocab_size=cfg.vocab_size, seq_len=TRAIN_CUT_SEQ,
                  batch_size=TRAIN_CUT_BATCH, device="cuda")
    step = build_train_step(model, TrainSettings(lr=3e-3))
    steps = []
    reset_launches()
    t0 = time.perf_counter()
    for i in range(TRAIN_CUT_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step(state, {"tokens": task.batch(0, i)})
        steps.append((float(metrics["loss"]), time.perf_counter() - t1))
    secs = time.perf_counter() - t0
    counts = launches()
    phase = "train_rg" if arch == RG_ARCH else "train_mamba"
    rec = train_record(phase, cfg, steps, counts, secs, TRAIN_CUT_BATCH,
                       TRAIN_CUT_SEQ, torch.cuda.max_memory_allocated())
    from repro_torch.core.types import tree_leaves
    rec.update(cut=f"depth: {get_config(arch).num_layers} layers cut to "
               f"{cfg.num_layers} ({', '.join(cfg.pattern_unit)} x "
               f"{cfg.unit_repeats}{', no prologue' if arch == RG_ARCH else ''})"
               f"; width as published", pods=1,
               params=sum(l.numel() for l in tree_leaves(state["theta"])),
               expected_launches=kernel_counts(cfg, TRAIN_CUT_STEPS))
    del state
    emit(rec)
    if not all(np.isfinite(l) for l, _ in steps):
        raise AssertionError(f"{phase}: non-finite losses")
    check_counts(phase, counts, rec["expected_launches"])
    return rec


def phase_cluster_lm():
    """launch.cluster.main --preset lm (qwen2-1.5b reduced, the tiny-LM
    overrides): deterministic, dana-zero, 4 workers, 64 gradients, with
    --compare-engine, which must print BIT-EXACT (the CLI runs a
    deterministic cluster on the tree path, as the JAX CLI does: no
    flat kernel launches; cluster_lm_full runs the flat path
    deterministically); then free, coalescing up to 4, on the flat path:
    one flat_update_batch a drained batch."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import cluster as cluster_mod
    recs = {}
    for mode, extra in (("deterministic", ["--compare-engine"]),
                        ("free", ["--coalesce", "4"])):
        reset_launches()
        t0 = time.perf_counter()
        summary = cluster_mod.main([
            "--preset", "lm", "--model", TRAIN_ARCH, "--algo", "dana-zero",
            "--mode", mode, "--workers", str(CLUSTER_LM_WORKERS),
            "--grads", str(CLUSTER_LM_GRADS)] + extra)
        torch.cuda.synchronize()
        counts = launches()
        rec = {"phase": f"cluster_lm_{mode}", "seconds":
               time.perf_counter() - t0,
               "updates_per_s": summary["updates_per_s"],
               "steady_updates_per_s": summary["steady_updates_per_s"],
               "master_updates_per_s": summary["master_updates_per_s"],
               "coalesce_counts": summary["coalesce_counts"],
               "flat": summary["flat"], "use_kernel": summary["use_kernel"],
               "final_loss": summary["final_loss"],
               "launches": {k: n for k, n in counts.items() if n}}
        flat = mode == "free"
        if not flat:
            rec["engine_max_param_diff"] = summary["engine_max_param_diff"]
        emit(rec)
        if summary["flat"] != flat or not np.isfinite(summary["final_loss"]):
            raise AssertionError(f"cluster_lm {mode}: flat path "
                                 f"{summary['flat']}, final loss "
                                 f"{summary['final_loss']}")
        batches = sum(summary["coalesce_counts"].values())
        if flat and (counts["flat_update_batch"] != batches
                     or counts["send_view"] < CLUSTER_LM_WORKERS):
            raise AssertionError(f"cluster_lm {mode}: launches {counts}")
        if not flat and counts["flat_update_batch"] + counts["send_view"]:
            raise AssertionError(f"cluster_lm {mode}: the tree path "
                                 f"launched {counts}")
        if mode == "deterministic" and rec["engine_max_param_diff"] != 0.0:
            raise AssertionError("cluster_lm: the deterministic cluster "
                                 "differs from the engine")
        recs[mode] = rec
    return recs


def phase_cluster_lm_procs():
    """launch.cluster.main --preset lm --backend process (qwen2-1.5b
    reduced, the tiny-LM overrides): dana-zero, PROCS_LM_WORKERS worker
    processes, PROCS_LM_GRADS gradients, free: a finite final loss; the
    shard child's flat_update_batch once a drained batch and the worker
    children's swa_attention launches (the dense attn kind), counted in
    the children and summed by the parent."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import cluster as cluster_mod
    reset_launches()
    t0 = time.perf_counter()
    summary = cluster_mod.main([
        "--preset", "lm", "--model", TRAIN_ARCH, "--algo", "dana-zero",
        "--mode", "free", "--backend", "process", "--workers",
        str(PROCS_LM_WORKERS), "--grads", str(PROCS_LM_GRADS)])
    torch.cuda.synchronize()
    counts = {k: n for k, n in launches().items() if n}
    lc = summary["launches"]
    rec = {"phase": "cluster_lm_procs",
           "seconds": time.perf_counter() - t0,
           "updates_per_s": summary["updates_per_s"],
           "steady_updates_per_s": summary["steady_updates_per_s"],
           "coalesce_counts": summary["coalesce_counts"],
           "final_loss": summary["final_loss"],
           "spawn_s": summary["spawn_s"], "launches_children": lc,
           "launches_parent": counts,
           "launches": {k: counts.get(k, 0) + lc.get(k, 0)
                        for k in set(counts) | set(lc)}}
    emit(rec)
    batches = sum(summary["coalesce_counts"].values())
    if (not np.isfinite(summary["final_loss"])
            or summary["backend"] != "process"
            or lc.get("flat_update_batch") != batches
            or not lc.get("swa_attention")
            or counts.get("send_view") != PROCS_LM_WORKERS):
        raise AssertionError(f"cluster_lm_procs: loss "
                             f"{summary['final_loss']}, children {lc}, "
                             f"parent {counts}, {batches} batches")
    return rec


def phase_cluster_lm_full(card):
    """qwen2-1.5b at full width, depth cut to 2 layers
    (ModelGradFn(reduced=False, overrides=...)), dana-zero, 4 workers:
    first flat_update_batch (k=1, telemetry on, the gradient as a
    separate buffer, as the deterministic master calls it) and send_view
    (N=1) on random inputs at the rows of this model's packed state,
    each against its plain version; then one deterministic cluster pass
    of 16 gradients on the flat kernel path; then the engine on the same
    run with the kernels (bit for bit the cluster's final parameters:
    the plumbing) and on the tree path without kernels (within 1e-3
    relative L2, as main_path: the kernels on a real model's ragged
    state)."""
    from repro_torch.cluster import ClusterConfig, run_cluster
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.engine import SimulationConfig, run_simulation
    from repro_torch.core.flat import FlatSpec
    from repro_torch.core.types import HyperParams, tree_leaves
    from repro_torch.data.synthetic import LMTask
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.api import ModelGradFn
    grad_fn = ModelGradFn(TRAIN_ARCH, reduced=False,
                          overrides=CLUSTER_LM_FULL_CUT, mesh_shape=(1, 1))
    model = grad_fn.build_model()
    task = LMTask(vocab_size=model.cfg.vocab_size, seq_len=64,
                  batch_size=CLUSTER_LM_FULL_BATCH, device="cuda")
    params0 = grad_fn.init(torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    rows = FlatSpec.from_tree(params0).rows
    label = "qwen2-1.5b 2 layers (cluster_lm_full)"
    checks = {"flat_update_batch": check_batch(
        card, f"dana-zero k=1 telemetry, cluster wire, {label}", rows,
        CLUSTER_LM_WORKERS, [1], False, True, False, False, "v0", True,
        time_it=False, seed=96, wire=True)}
    torch.cuda.empty_cache()
    checks["send_view"] = check_send(card, f"dana-zero N=1, {label}", rows,
                                     1, False, seed=14)
    torch.cuda.empty_cache()
    ev = task.eval_batch(8)

    @torch.no_grad()
    def eval_fn(params):
        return model.loss(params, {"tokens": ev})
    hp = HyperParams(lr=0.05, momentum=0.9)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stats = {}
    hist = run_cluster(make_algorithm("dana-zero", hp), grad_fn, params0,
                       task.batch, ClusterConfig(
                           num_workers=CLUSTER_LM_WORKERS,
                           total_grads=CLUSTER_LM_FULL_GRADS,
                           eval_every=CLUSTER_LM_FULL_GRADS,
                           mode="deterministic", use_kernel=True,
                           device="cuda"), eval_fn, stats_out=stats)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    final = tree_leaves(hist.final_params)
    del hist

    def engine(use_kernel):
        return run_simulation(
            make_algorithm("dana-zero", hp), grad_fn, params0, task.batch,
            SimulationConfig(num_workers=CLUSTER_LM_WORKERS,
                             total_grads=CLUSTER_LM_FULL_GRADS,
                             eval_every=CLUSTER_LM_FULL_GRADS,
                             use_kernel=use_kernel, device="cuda"), eval_fn)
    h2 = engine(True)
    equal = all(torch.equal(a, b) for a, b in
                zip(final, tree_leaves(h2.final_params)))
    del h2
    reset_launches()
    h3 = engine(False)
    tree_counts = launches()
    final_t = tree_leaves(h3.final_params)
    p0 = tree_leaves(params0)
    rel = rel_l2(final, final_t)
    step_rel = rel_l2([a - b for a, b in zip(final, p0)],
                      [a - b for a, b in zip(final_t, p0)])
    rec = {"phase": "cluster_lm_full", "arch": model.cfg.name,
           "cut": "depth: 28 layers cut to 2; width as published",
           "params": sum(l.numel() for l in final), "rows": rows,
           "seconds": secs, "updates_per_s": stats["updates_per_s"],
           "master_updates_per_s": stats["master_updates_per_s"],
           "peak_mem_gb": peak / 1e9, "eval_loss_tree": h3.eval_loss,
           "launches": {k: n for k, n in counts.items() if n},
           "launches_tree_path": {k: n for k, n in tree_counts.items()
                                  if n},
           "final_params_bit_equal_to_engine": equal,
           "final_params_rel_l2_kernel_vs_tree": rel,
           "displacement_rel_l2_kernel_vs_tree": step_rel,
           "kernel_max_abs_err": {k: r["max_abs_err"]
                                  for k, r in checks.items()}}
    finite = all(bool(torch.isfinite(l).all()) for l in final)
    del final, final_t, h3
    emit(rec)
    if counts["flat_update_batch"] != CLUSTER_LM_FULL_GRADS or \
            counts["send_view"] < CLUSTER_LM_WORKERS or not equal:
        raise AssertionError(f"cluster_lm_full: launches {counts}, "
                             f"equal to the engine {equal}")
    if tree_counts["flat_update_batch"] + tree_counts["send_view"]:
        raise AssertionError(f"cluster_lm_full: the tree path launched "
                             f"{tree_counts}")
    if not finite or rel > 1e-3:
        raise AssertionError(f"cluster_lm_full: kernel path and tree path "
                             f"disagree: relative L2 {rel}, finite "
                             f"{finite}")
    return rec


def phase_swa_dense(card):
    """swa_attention at qwen2-1.5b's training shape, one pod's batch:
    bf16 (4, 512, 12 heads, 2 kv heads, hd 128), window 512 (plain
    causal), against its plain version; timed beside
    scaled_dot_product_attention(is_causal=True) on K/V repeated to 12
    heads; the bound: bytes (q, k, v read once, the output written
    once) against the causal pairs' bf16 operations."""
    from repro_torch.kernels.swa_attention import swa_attention_gqa
    from repro_torch.kernels.swa_attention.kernel import swa_attention_cuda
    b, s, h, kh, hd = TRAIN_BATCH // TRAIN_PODS, TRAIN_SEQ, 12, 2, 128
    rec = check_swa(card, f"dense B={b} S={s} H={h} K={kh} hd={hd} w={s}",
                    b, s, h, kh, hd, s, torch.bfloat16, 64)
    g = torch.Generator(device="cuda").manual_seed(64)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).bfloat16()
               for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(h // kh, dim=2).transpose(1, 2)
              for t in (k, v))

    def lib():
        return sdpa(qt, kt, vt, is_causal=True)
    ref = swa_attention_gqa(q, k, v, s)
    torch.cuda.synchronize()
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kh * hd)
    nops = 4 * b * h * hd * (s * (s + 1) // 2)
    tb, to = nbytes / card.bw * 1e3, nops / card.bf16 * 1e3
    rec.update(
        phase="swa_attention_dense", shape="qwen2-1.5b training, one pod",
        ms=time_ms(lambda: swa_attention_cuda(q, k, v, s)),
        plain_ms=time_ms(lambda: swa_attention_gqa(q, k, v, s)),
        library="torch.nn.functional.scaled_dot_product_attention("
                "is_causal=True), K/V repeated to 12 heads",
        library_ms=time_ms(lib),
        library_max_abs_err=float((lib().transpose(1, 2).float()
                                   - ref.float()).abs().max()),
        library_device_ms=device_ms(lib, "", per_call=True),
        device_ms=device_ms(lambda: swa_attention_cuda(q, k, v, s),
                            "swa_attention"),
        bytes=nbytes, flops=nops, bound_bytes_ms=tb, bound_ops_ms=to,
        bound_ms=max(tb, to), bound_by="bytes" if tb >= to else
        "operations")
    rec["device_share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
    rec["device_tflops"] = nops / rec["device_ms"] / 1e9
    emit(rec)
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import (  # noqa: F401
        _build, dana_update, flat_update, mamba_scan, rglru_scan,
        swa_attention)
    card = Card()
    emit({"phase": "device", "nvidia_smi": card.smi, "kind": card.name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "numpy": np.__version__,
          "python": sys.version.split()[0],
          "peak_bandwidth_Bps": card.bw, "peak_f32_flops": card.f32,
          "sms": card.sms, "max_sm_mhz": card.max_sm_mhz,
          "peak_exp_per_s": card.exp_rate,
          # what time_ms reads for a call that does nothing: the floor
          # under every "ms" of a short call
          "empty_call_ms": time_ms(lambda: None)})
    t0 = time.perf_counter()
    _build.build_all()             # one nvcc per source, all at once
    for lib in _build.LIBRARIES:
        lib.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {lib.name: {
              "nvcc_seconds": lib.info.get("seconds"),
              "ptxas": [ln for ln in lib.info.get("ptxas", "").splitlines()
                        if "registers" in ln or "spill" in ln]}
              for lib in _build.LIBRARIES}})
    fu = phase_flat_update(card)
    sv = phase_send_view(card)
    du = phase_dana_update(card)
    gu = phase_gap_update(card)
    ms = phase_mamba_scan(card)
    rs = phase_rglru_scan(card)
    sw = phase_swa_attention(card)
    sd = phase_swa_dense(card)
    phase_lm_grad()
    conf = configuration()
    main_rec, hist_e, final_e = phase_main_path(conf)
    paths = {"main_path": main_rec,
             "cluster_deterministic": phase_cluster_deterministic(
                 conf, hist_e, final_e)}
    paths["sharded_deterministic"] = phase_sharded_deterministic(
        conf, hist_e, final_e)
    del hist_e, final_e
    paths["cluster_free"] = phase_cluster_free(conf)
    paths["sharded_free"] = phase_sharded_free(conf, paths["cluster_free"])
    paths["procs_pinned"] = phase_procs_pinned(conf)
    paths.update({f"procs_free S={S}": r for S, r in phase_procs_free(
        conf, paths["cluster_free"], paths["sharded_free"]).items()})
    paths["hot_rows"] = phase_hot_rows(card, conf)
    paths["cluster_legacy"] = phase_cluster_legacy(conf)
    del conf
    torch.cuda.empty_cache()
    conf_ga, paths["main_path_ga"], hist_e, final_e = phase_main_path_ga()
    paths["cluster_ga_deterministic"] = phase_cluster_deterministic(
        conf_ga, hist_e, final_e, phase="cluster_ga_deterministic",
        grads=GA_GRADS, expect=lambda c: c["gap_update"] == GA_GRADS)
    paths["sharded_ga"] = phase_sharded_ga(conf_ga, final_e)
    del hist_e, final_e
    paths["cluster_ga_free"] = phase_cluster_ga_free(conf_ga)
    paths["procs_ga"] = phase_procs_ga(conf_ga)
    del conf_ga
    torch.cuda.empty_cache()
    paths.update({f"member {k}": r for k, r in phase_members().items()})
    torch.cuda.empty_cache()
    paths.update({f"member {k}": r
                  for k, r in phase_members_offflat().items()})
    torch.cuda.empty_cache()
    model, params, info = serve_model()
    paths["serve_generate"] = phase_serve_generate(model, params, info)
    torch.cuda.empty_cache()
    paths["serve_engine"] = phase_serve_engine(model, params)
    del model, params
    torch.cuda.empty_cache()
    model, params, info = serve_model(RG_ARCH)
    paths["serve_generate_rg"] = generate_phase(
        model, params, info, "serve_generate_rg", SERVE_BATCH, SERVE_PROMPT,
        SERVE_GEN, rg_generate_expect(SERVE_GEN))
    torch.cuda.empty_cache()
    paths["serve_generate_rg_long"] = generate_phase(
        model, params, {}, "serve_generate_rg_long", RG_LONG_BATCH,
        RG_LONG_PROMPT, RG_LONG_GEN, rg_generate_expect(RG_LONG_GEN), seed=2)
    torch.cuda.empty_cache()
    paths["serve_engine_rg"] = phase_serve_engine(
        model, params, "serve_engine_rg", rg_engine_expect)
    del model, params
    torch.cuda.empty_cache()
    paths["train_qwen2"] = phase_train_qwen2()
    torch.cuda.empty_cache()
    paths["train_rg"] = phase_train_cut(RG_ARCH)
    torch.cuda.empty_cache()
    paths["train_mamba"] = phase_train_cut(SERVE_ARCH)
    torch.cuda.empty_cache()
    cl = phase_cluster_lm()
    paths["cluster_lm_deterministic"] = cl["deterministic"]
    paths["cluster_lm_free"] = cl["free"]
    paths["cluster_lm_procs"] = phase_cluster_lm_procs()
    paths["cluster_lm_full"] = phase_cluster_lm_full(card)
    torch.cuda.empty_cache()
    kernels = []
    for name, rec, path, src, replaces in (
            ("flat_update_batch", fu["main"], "main_path", SRC,
             "src/repro/kernels/flat_update/kernel.py:226"),
            ("send_view", sv["main"], "main_path", SRC,
             "src/repro/kernels/flat_update/send.py:86"),
            ("dana_master_update", du["main"], "cluster_legacy", DANA_SRC,
             "src/repro/kernels/dana_update/kernel.py:42"),
            ("gap_update", gu["main"], "main_path_ga", GAP_SRC,
             "src/repro/kernels/flat_update/kernel.py:743"),
            ("mamba_scan", ms["main"], "serve_generate", SCAN_SRC,
             "src/repro/kernels/mamba_scan/kernel.py:48"),
            ("rglru_scan", rs["main"], "serve_generate_rg", RGLRU_SRC,
             "src/repro/kernels/rglru_scan/kernel.py:42"),
            ("swa_attention", sw["main"], "serve_generate_rg", SWA_SRC,
             "src/repro/kernels/swa_attention/kernel.py:76"),
            # the scalar-prefetch lowering: the free cluster's coalesced
            # k=8 batches, the case it was written for
            ("flat_update_batch", fu["cluster"], "cluster_free", SRC,
             "src/repro/kernels/flat_update/kernel.py:497")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": paths[path]["launches"][name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            "launches_by_path": {p: r["launches"].get(name, 0)
                                 for p, r in paths.items()}})
    kernels[0]["also_replaces"] = "src/repro/kernels/flat_update/kernel.py:497"
    for key in ("ms", "device_ms", "bound_ms", "plain_ms", "max_abs_err"):
        kernels[0][f"{key}_k8_cluster_wire"] = fu["cluster"][key]
        kernels[3][f"{key}_k8"] = gu["k8"][key]
        kernels[3][f"{key}_k8_adjacent"] = gu["k8_adjacent"][key]
        kernels[3][f"{key}_k2_adjacent"] = gu["k2_adjacent"][key]
    kernels[0]["device_ms"] = fu["main"]["device_ms"]
    kernels[2]["device_ms"] = du["main"]["device_ms"]
    kernels[3]["also_replaces"] = "src/repro/kernels/flat_update/kernel.py:828"
    for key in ("device_ms", "kernels_a_call", "bit_identical_on_relaunch"):
        kernels[3][key] = gu["main"][key]
        kernels[3][f"{key}_k8"] = gu["k8"][key]
    kernels[7]["device_ms"] = fu["cluster"]["device_ms"]
    for key in ("device_ms", "bound_ms", "device_share_of_bound"):
        kernels[1][key] = sv["main"][key]
        for mode in ("weighted", "adaptive"):
            kernels[1][f"{key}_{mode}_N64"] = sv[mode][key]
    for mode in ("weighted", "adaptive"):
        kernels[1][f"ms_{mode}_N64"] = sv[mode]["ms"]
    kernels[1]["library_device_ms"] = sv["main"]["library_device_ms"]
    kernels[1]["bit_equal"] = sv["main"]["bit_equal"]
    # the row-range (strided) calls of the hot-row path
    kernels[1]["launches_hot_rows"] = \
        paths["hot_rows"]["launches"]["send_view"]
    for label, r in paths["hot_rows"]["ranges"].items():
        for key in ("rows", "device_ms_N1", "device_ms_N64", "bound_ms_N1",
                    "bound_ms_N64", "bound_by_N64",
                    "N64_max_abs_err_vs_plain"):
            kernels[1][f"rows_{label}_{key}"] = r[key]
    for key in ("ms", "device_ms", "bound_ms", "plain_ms", "max_abs_err",
                "bound_by", "last_bit_equal", "layout"):
        kernels[4][f"{key}_decode_S1"] = ms["decode"][key]
        kernels[4][f"{key}_engine_prefill"] = ms["engine"][key]
    kernels[4]["inputs_engine_prefill"] = ms["engine"]["inputs"]
    for key in ("bound_bytes_ms", "bound_f32_ms", "bound_exp_ms",
                "device_ms", "last_bit_equal", "layout"):
        kernels[4][key] = ms["main"][key]
    for key in ("bf16_prefill", "bf16_decode"):
        kernels[4][f"max_abs_err_{key}"] = ms[key]["max_abs_err"]
    for key in ("ms", "device_ms", "bound_ms", "plain_ms", "max_abs_err",
                "bound_by", "library_ms", "device_share_of_bound",
                "bit_equal"):
        kernels[5][f"{key}_decode_S1"] = rs["decode"][key]
        kernels[5][f"{key}_long_S3072"] = rs["long"][key]
    kernels[5]["library_decode_S1"] = rs["decode"]["library"]
    kernels[5]["library_device_ms_decode_S1"] = \
        rs["decode"]["library_device_ms"]
    for key in ("device_ms", "device_share_of_bound", "bit_equal"):
        kernels[5][key] = rs["main"][key]
    for key in ("ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err",
                "bound_by", "device_ms", "tflops", "device_tflops"):
        kernels[6][f"{key}_long_S3072"] = sw["long"][key]
    for key in ("bound_bytes_ms", "bound_ops_ms", "ops_rate", "dtype",
                "device_ms", "tflops", "device_tflops"):
        kernels[6][key] = sw["main"][key]
    for key in ("ms", "device_ms", "bound_ms", "bound_by", "plain_ms",
                "library_ms", "library_device_ms", "max_abs_err",
                "device_tflops", "device_share_of_bound", "library"):
        kernels[6][f"{key}_dense_train"] = sd[key]
    kernels[6]["launches_train_qwen2"] = \
        paths["train_qwen2"]["launches"]["swa_attention"]
    emit({"kernels": kernels})
    print(card.smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card.name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
