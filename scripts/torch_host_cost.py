#!/usr/bin/env python3
"""Time the host work of the ``send_view``, ``mamba_scan`` and
``rglru_scan`` wrappers, piece by piece, and the kernels' device times at
their paths' shapes (with ``gap_update``'s).

    python3 scripts/torch_host_cost.py [--calls 10000] [--no-device]
                                       [--src DIR]

Host pieces: each piece of a wrapper call (its checks, the output
allocation, the library lookup, the device context, the stream lookup,
the ctypes call that launches the kernel, the launch counter) runs
``--calls`` times in a loop timed with ``time.perf_counter`` after a
warm-up; the line gives microseconds per call.  The tensors are small,
so the device keeps up with the launches and the loop measures the host
alone.  Beside them: the whole wrapper call, ``torch.add`` (send_view's
one-call yardstick), ``torch.ones`` (the unit weights the flat send
path allocated at every send before), and the private raw-stream and
current-device calls beside the public ones.

SASS: static instruction counts of each ``mamba_scan`` kernel instance
(``cuobjdump -sass`` of the built library): f32-pipe instructions (FFMA,
FMUL, FADD) per MUFU.EX2, the cost of a state step as compiled.

Device times (unless ``--no-device``): ``send_view`` at R=197,000 in its
three ``chip_smoke.py`` modes (N=1; weighted N=64; adaptive N=64) and
``mamba_scan`` at prefill (4, 512, 8192, 16), the Engine's prefill (1,
256, 8192, 16) and decode (4, 1, 8192, 16), from torch.profiler, beside
each call's CUDA-event time (``chip_smoke.device_ms`` and ``time_ms``)
and its bound; at N=1 also the wrapper and the bare C entry point (no
checks, no allocation) each timed in turns with ``torch.add``
(``chip_smoke.time_pair``), which splits the call's time between the
launch and the wrapper's Python work; at both prefill shapes the
chunked kernel's device time with one and with two channels a lane,
launched through the C entry point (the wrapper picks one by B*D).
``rglru_scan`` at prefill (4, 512, 4096), the long prompt (1, 3072,
4096) and decode (4, 1, 4096), the decode call in turns with
``torch.addcmul``; ``gap_update`` at k=1 and k=8 (R=197,000, N=64), its
device time a call; the bf16 ``swa_attention`` kernel at its causal
serve and train shapes (``SWA_CAUSAL_SHAPES``).  One JSON line per
section; exits 2 without a card.

``--src DIR`` times the wrappers of another checkout's ``src`` (an
earlier commit's, unpacked with ``git archive``) with this script's
timers; the pieces that tree does not have are left out.  Runs of two
trees taken in turns (A, B, B, A) compare them on one card.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (puts src/ on the path)



def _pitch(lib, rows):
    """The slab pitch argument of ``send_view`` (since its row-range
    form; a checkout from before it, through ``--src``, takes none)."""
    return (rows * 128,) if len(lib.send_view.argtypes) == 11 else ()

def per_call_us(fn, calls):
    for _ in range(min(calls, 200)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_pieces(calls):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flat_update import _build as fbuild
    from repro_torch.kernels.flat_update import send
    from repro_torch.kernels.mamba_scan import kernel as mk
    dev = torch.device("cuda", torch.cuda.current_device())
    idx = dev.index
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # send_view at a small R: the host's work does not depend on R
    theta, slab, w = randn(64, 128), randn(1, 64, 128), torch.ones(1,
                                                                  device=dev)
    c = float(np.float32(0.05) * np.float32(0.9))
    lib = fbuild.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(theta)
    sv = {
        "empty_like": lambda: torch.empty_like(theta),
        "load": fbuild.load,
        "stream_public": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes_call": lambda: lib.send_view(
            theta.data_ptr(), slab.data_ptr(), w.data_ptr(), c, None, 1e-8,
            out.data_ptr(), 64, 1, *_pitch(lib, 64), stream),
        "count": lambda: _build.count("send_view"),
        "whole_call": lambda: send.flat_send_view(theta, slab, w, c),
        "torch_add": lambda: torch.add(theta, slab[0], alpha=-c),
        "torch_ones_unit_weights": lambda: torch.ones(
            (1,), dtype=torch.float32, device=dev),
    }
    if hasattr(send, "_send_checks"):
        sv["checks"] = lambda: send._send_checks(theta, slab, w, None)
    common = {
        "device_context_enter_exit": _context_cost(dev),
        "current_device_public": lambda: torch.cuda.current_device(),
        "current_device_raw": lambda: torch._C._cuda_getDevice(),
        "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(idx),
    }
    if hasattr(_build, "launch"):
        common["launch_helper_noop"] = lambda: _build.launch(
            _noop, idx, 1, 2, 3)

    # mamba_scan at a small decode shape
    x, dl = randn(1, 1, 256), torch.nn.functional.softplus(
        randn(1, 1, 256)) * 0.1
    bm, cm, a, h0 = randn(1, 1, 16), randn(1, 1, 16), -randn(256, 16).abs(), \
        randn(1, 256, 16)
    slib = mk.LIB.load()
    y, last = torch.empty_like(x), torch.empty_like(h0)
    ptrs = [t.data_ptr() for t in (x, dl, bm, cm, a, h0, y, last)]
    if len(slib.mamba_scan.argtypes) == 13:    # the earlier entry point
        scan_args = (*ptrs, 1, 1, 256, 16)
    else:                                      # B's strides, flags
        scan_args = (*ptrs, 1, 1, 256, *bm.stride()[:2], 16 << 8 | 1 << 1)
    ms = {
        "empty_like_x2": lambda: (torch.empty_like(x),
                                  torch.empty_like(h0)),
        "load": mk.LIB.load,
        "stream_public": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes_call": lambda: slib.mamba_scan(*scan_args, stream),
        "count": lambda: _build.count("mamba_scan"),
        "whole_call": lambda: mk.mamba_scan_cuda(x, dl, bm, cm, a, h0),
    }
    if hasattr(mk, "_scan_checks"):
        ms["checks"] = lambda: mk._scan_checks(x, dl, bm, cm, a, h0)
    # rglru_scan at recurrentgemma-9b's decode shape
    from repro_torch.kernels.rglru_scan import kernel as rk
    ra, rx, rh = (torch.sigmoid(randn(4, 1, 4096)), randn(4, 1, 4096),
                  randn(4, 4096))
    rlib = rk.LIB.load()
    ro, rl = torch.empty_like(ra), torch.empty_like(rh)
    rptrs = [t.data_ptr() for t in (ra, rx, rh, ro, rl)]
    rargs = ((*rptrs, 4, 1, 4096, 1) if len(rlib.rglru_scan.argtypes) == 10
             else (*rptrs, 4, 1, 4096))   # the earlier entry point
    rhv = rh[:, None]
    rs = {
        "empty_like_x2": lambda: (torch.empty_like(ra),
                                  torch.empty_like(rh)),
        "ctypes_call": lambda: rlib.rglru_scan(*rargs, stream),
        "whole_call": lambda: rk.rglru_scan_cuda(ra, rx, rh),
        "torch_addcmul": lambda: torch.addcmul(rx, ra, rhv),
    }
    if hasattr(rk, "_scan_checks"):
        rs["checks"] = lambda: rk._scan_checks(ra, rx, rh)
    res = {}
    for group, pieces in (("send_view", sv), ("mamba_scan", ms),
                          ("rglru_scan", rs), ("common", common)):
        res[group] = {k: per_call_us(f, calls) for k, f in pieces.items()}
    return res


def _noop(*args):
    return 0


def _context_cost(dev):
    def enter_exit():
        with torch.cuda.device(dev):
            pass
    return enter_exit


def device_times(card):
    from repro_torch.kernels.flat_update import _build as _fbuild
    from repro_torch.kernels.flat_update.send import flat_send_view
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
    out = {"send_view": [], "mamba_scan": []}
    c = np.float32(0.05) * np.float32(0.9)
    r = chip_smoke.R_FULL
    for label, n, adaptive in (("N=1", 1, False), ("weighted N=64", 64,
                                                   False),
                               ("adaptive N=64", 64, True)):
        gen = torch.Generator(device="cuda").manual_seed(n + adaptive)
        theta = torch.randn((r, 128), generator=gen, device="cuda")
        slab = torch.randn((n, r, 128), generator=gen, device="cuda")
        w = torch.rand(n, generator=gen, device="cuda") + 0.5
        u2 = theta.abs() * 0.01 if adaptive else None

        def call():
            return flat_send_view(theta, slab, w, c, u2)
        p = r * 128
        nbytes = 4 * p * (n + 2 + adaptive)
        bound, by = card.bound(nbytes, p * (2 * n + 2 + 3 * adaptive))
        dms = chip_smoke.device_ms(call, "send_view")
        rec = {"mode": label, "R": r, "N": n, "ms": chip_smoke.time_ms(call),
               "device_ms": dms, "bound_ms": bound, "bound_by": by,
               "device_share_of_bound": bound / dms}
        if n == 1:
            def add():
                return torch.add(theta, slab[0], alpha=-float(c))

            lib = _fbuild.load()
            out_ = torch.empty_like(theta)
            stream = torch.cuda.current_stream().cuda_stream

            def bare():        # the C entry point alone: no checks, no
                return lib.send_view(   # allocation, a stream at hand
                    theta.data_ptr(), slab.data_ptr(), w.data_ptr(),
                    float(c), None, 1e-8, out_.data_ptr(), r, 1,
                    *_pitch(lib, r), stream)
            rec["torch_add_ms"] = chip_smoke.time_ms(add)
            rec["torch_add_device_ms"] = chip_smoke.device_ms(add, "add")
            # in turns: the wrapper against torch.add, the bare entry
            # point against torch.add
            rec["in_turns_ms"] = dict(zip(("wrapper", "torch_add"),
                                          chip_smoke.time_pair(call, add)))
            rec["in_turns_bare_ms"] = dict(zip(
                ("bare_entry_point", "torch_add"),
                chip_smoke.time_pair(bare, add)))
        out["send_view"].append(rec)
        del theta, slab, w, u2
        torch.cuda.empty_cache()
    for label, (b, s) in (("prefill", (4, 512)), ("engine prefill",
                                                  (1, 256)),
                          ("decode", (4, 1))):
        args = chip_smoke.scan_inputs(b, s, 8192, 16, 41, zero_h0=s > 1)

        def call():
            return mamba_scan_cuda(*args)
        nbytes, nops, nexp = chip_smoke.scan_bytes_ops(b, s, 8192, 16)
        bound, by = card.bound(nbytes, nops, nexp)
        rec = {"shape": label, "B": b, "S": s, "D": 8192, "N": 16,
               "ms": chip_smoke.time_ms(call),
               "device_ms": chip_smoke.device_ms(call, "mamba_scan"),
               "bound_ms": bound, "bound_by": by,
               "bound_f32_ms": nops / card.f32 * 1e3}
        if s > 1 and len(mk.LIB.load().mamba_scan.argtypes) == 15:
            rec["device_ms_by_channels_a_lane"] = {
                per_lane: chip_smoke.device_ms(
                    lambda: _scan_entry(args, per_lane), "mamba_scan")
                for per_lane in (1, 2)}
        out["mamba_scan"].append(rec)
    out["rglru_scan"] = rglru_times(card)
    out["gap_update"] = gap_times(card)
    out["swa_attention"] = swa_times()
    return out


# B7's causal shapes on the serve and train paths: recurrentgemma-9b's
# prefill and long prompt (window 2048), qwen2-1.5b's training shape,
# the four decoder-only families' prefills (dense: window = S); (B, S,
# H, K, hd, window)
SWA_CAUSAL_SHAPES = [(4, 512, 16, 1, 256, 2048), (1, 3072, 16, 1, 256, 2048),
                     (4, 512, 12, 2, 128, 512), (4, 512, 32, 2, 128, 512),
                     (4, 512, 24, 8, 64, 512), (4, 512, 40, 8, 128, 512),
                     (4, 768, 28, 4, 128, 768)]


def swa_times():
    """The bf16 swa_attention kernel's device time at SWA_CAUSAL_SHAPES
    (a checkout from before the enc-dec masks, through ``--src``, takes
    the same call)."""
    from repro_torch.kernels.swa_attention.kernel import swa_attention_cuda
    out = {}
    for b, s, h, kh, hd, w in SWA_CAUSAL_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn(sh, device="cuda", generator=g).bfloat16()
                   for sh in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
        out[f"{b},{s},{h},{kh},{hd},{w}"] = chip_smoke.device_ms(
            lambda: swa_attention_cuda(q, k, v, w), "swa_attention")
    return out


def rglru_times(card):
    """rglru_scan at recurrentgemma-9b's prefill (4, 512), the long
    prompt (1, 3072) and decode (4, 1), D=4096: the call, its device
    time and bound; at decode in turns with torch.addcmul."""
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    recs = []
    for label, (b, s) in (("prefill", (4, 512)), ("long prompt", (1, 3072)),
                          ("decode", (4, 1))):
        a, x, h0 = chip_smoke.rglru_inputs(b, s, 4096, 51, zero_h0=s > 1)

        def call():
            return rglru_scan_cuda(a, x, h0)
        nbytes = 4 * (3 * b * s * 4096 + 2 * b * 4096)
        bound, by = card.bound(nbytes, 2 * b * s * 4096)
        rec = {"shape": label, "B": b, "S": s, "D": 4096,
               "ms": chip_smoke.time_ms(call),
               "device_ms": chip_smoke.device_ms(call, "rglru"),
               "bound_ms": bound, "bound_by": by}
        if s == 1:
            hv = h0[:, None]
            rec["in_turns_ms"] = dict(zip(
                ("wrapper", "torch_addcmul"), chip_smoke.time_pair(
                    call, lambda: torch.addcmul(x, a, hv))))
        recs.append(rec)
    return recs


def gap_times(card):
    """gap_update at R=197,000, N=64, telemetry on, k=1 and k=8 (chip_smoke's
    IDS8): the call and its device time a call (every kernel it runs)."""
    from repro_torch.kernels.flat_update.kernel import flat_update_batch_gap
    r, n = chip_smoke.R_FULL, chip_smoke.WORKERS
    gen = torch.Generator(device="cuda").manual_seed(3)
    theta = torch.randn((r, 128), generator=gen, device="cuda")
    v = torch.randn((n, r, 128), generator=gen, device="cuda") * 0.1
    sent = theta + 0.01 * torch.randn((n, r, 128), generator=gen,
                                      device="cuda")
    avg = torch.full((), 1e-3, device="cuda")
    recs = []
    for ids in ([17], chip_smoke.IDS8):
        k = len(ids)
        g = torch.randn((k, r, 128), generator=gen, device="cuda")
        scal = (np.full(k, 0.05, np.float32), np.full(k, 0.9, np.float32),
                np.ones(k, np.float32), np.ones(k, np.float32))

        def call():
            return flat_update_batch_gap(theta, v, sent, avg, g, ids, *scal,
                                         gap_ema=0.99, n_elems=r * 128,
                                         telemetry=True)
        least, one_pass, two_pass, nops = chip_smoke.gap_bytes_ops(
            r, ids, True)
        recs.append({"k": k, "ids": ids, "ms": chip_smoke.time_ms(call),
                     "device_ms": chip_smoke.device_ms(call, "gap_",
                                                       per_call=True),
                     "bound_ms": card.bound(least, nops)[0],
                     "one_pass_bound_ms": card.bound(one_pass, nops)[0],
                     "two_pass_bound_ms": card.bound(two_pass, nops)[0]})
        del g
        torch.cuda.empty_cache()
    return recs


def _scan_entry(args, per_lane):
    """The chunked scan kernel through its C entry point, on float32
    contiguous (B, S, D) inputs (D a multiple of 8), with ``per_lane``
    channels a lane."""
    from repro_torch.kernels.mamba_scan import kernel as mk
    x, dl, bm, cm, a, h0 = args
    bsz, s, d = x.shape
    y, last = torch.empty_like(dl), torch.empty_like(h0)
    flags = 1 << 1 | (per_lane == 2) << 2 | a.shape[1] << 8
    rc = mk.LIB.load().mamba_scan(
        *(t.data_ptr() for t in (x, dl, bm, cm, a, h0, y, last)), bsz, s, d,
        *bm.stride()[:2], flags, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"mamba_scan: CUDA error {rc}")
    return y, last


FP32_OPS = ("FFMA", "FMUL", "FADD")


def _label(name):
    """'chunked bf16, N=16, C=2' from a kernel's mangled name."""
    kinds = {"f": "f32", "t": "bf16"}
    m = re.search(r"mamba_scan_kernelI([ft])Li(\d+)ELi(\d+)E", name)
    if m:
        return f"chunked {kinds[m[1]]}, N={m[2]}, C={m[3]}"
    m = re.search(r"mamba_scan_step_kernelI([ft])Li(\d+)E", name)
    return f"step {kinds[m[1]]}, N={m[2]}" if m else name


def sass_counts():
    """Instruction counts of each mamba_scan kernel instance in the built
    library (``cuobjdump -sass``): the whole kernel's MUFU.EX2 and
    f32-pipe (FFMA, FMUL, FADD) instructions, and its step loop's
    instructions per state step (the loop back-edge with the fewest
    instructions per MUFU.EX2, one exponential a state step)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    from repro_torch.kernels.mamba_scan import kernel as mk
    text = subprocess.run([tool, "-sass", str(mk.LIB.path())],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                                 text, flags=re.S):
        insts = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);",
            body)]
        ops = [op for _, op, _ in insts]
        best = None
        for addr, op, rest in insts:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and target and int(target[1], 16) < addr:
                seg = [o for a, o, _ in insts
                       if int(target[1], 16) <= a <= addr]
                exps = sum(o.startswith("MUFU.EX2") for o in seg)
                if exps and (best is None
                             or len(seg) / exps < best[0] / best[1]):
                    best = (len(seg), exps)
        out[_label(name)] = {
            "instructions": len(ops),
            "mufu_ex2": sum(o.startswith("MUFU.EX2") for o in ops),
            "f32_pipe": sum(o.split(".")[0] in FP32_OPS for o in ops),
            "step_loop_instructions": best and best[0],
            "step_loop_exps": best and best[1],
            "instructions_per_state_step": best and best[0] / best[1]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=10_000)
    ap.add_argument("--no-device", action="store_true")
    ap.add_argument("--src", help="time the wrappers of this src directory")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    if not torch.cuda.is_available():
        print("torch_host_cost: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    card = chip_smoke.Card()
    import repro_torch
    print(json.dumps({"phase": "source", "src": str(Path(
        repro_torch.__file__).parents[1])}), flush=True)
    print(json.dumps({"phase": "host_cost_us_per_call", "calls": args.calls,
                      **host_pieces(args.calls),
                      "device": card.name, "nvidia_smi": card.smi}),
          flush=True)
    print(json.dumps({"phase": "mamba_scan_sass", **sass_counts()}),
          flush=True)
    if not args.no_device:
        print(json.dumps({"phase": "device_times", **device_times(card),
                          "device": card.name, "nvidia_smi": card.smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
