#!/usr/bin/env python3
"""Time the RG-LRU scan kernel's design alternatives beside the shipped
build: the channel tile (32, 64 and 128 channels a block) and TMA bulk
copies in place of cp.async.  They are the macros ``RGLRU_CHAIN_WARPS``
and ``RGLRU_TMA`` of ``src/repro_torch/kernels/rglru_scan/csrc/
rglru_scan.cu``, whose header describes them.

    python3 scripts/rglru_variants.py [--reps 20]

Each variant is built from that source with the package's nvcc flags and
its macros (one ``nvcc`` each, all started together) under
``build/rglru_variants/`` and called through its C entry point on the
current stream.  Timed shapes: recurrentgemma-9b's prefill (4, 512,
4096), the long prompt (1, 3072, 4096) and a short prompt (1, 256,
4096); device ms a launch from torch.profiler (``chip_smoke.device_ms``),
all variants of a shape twice, in turns (first to last, then last to
first), beside the shape's bytes bound.  Checked bit for bit against the
plain version (``rglru_scan_ref``) at every timed shape and at (2, 77,
1000) (a part tile on the aligned path), (2, 40, 1002) (one float a
thread) and (1, 5, 4096) (S shorter than a stage).  One JSON line a
shape; exits 2 without a card, 1 if a variant disagrees.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (puts src/ on the path)

VARIANTS = {                    # name -> macros
    "32 ch, cp.async (shipped)": (),
    "64 ch, cp.async": ("-DRGLRU_CHAIN_WARPS=2",),
    "128 ch, cp.async": ("-DRGLRU_CHAIN_WARPS=4",),
    "32 ch, TMA": ("-DRGLRU_TMA=1",),
    "128 ch, TMA": ("-DRGLRU_CHAIN_WARPS=4", "-DRGLRU_TMA=1"),
}
TIMED = ((4, 512, 4096), (1, 3072, 4096), (1, 256, 4096))
CHECKED = ((2, 77, 1000), (2, 40, 1002), (1, 5, 4096))


def build(out_dir):
    """Every variant's library, built in parallel; name -> bound CDLL."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import kernel as rk
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, macros) in enumerate(VARIANTS.items()):
        lib = out_dir / f"librglru_variant{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *macros, "-o", str(lib),
               str(rk.SOURCE)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
        rk._bind(libs[name])
    return libs


def scan(lib, a, x, h0):
    b, s, d = a.shape
    out, last = torch.empty_like(a), torch.empty_like(h0)
    vec = d % 4 == 0 and (a.data_ptr() | x.data_ptr() | h0.data_ptr()) % 16 \
        == 0
    rc = lib.rglru_scan(a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                        out.data_ptr(), last.data_ptr(), b, s, d, int(vec),
                        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rglru_scan: CUDA error {rc}")
    return out, last


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=chip_smoke.REPS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rglru_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.rglru_scan import rglru_scan_ref
    card = chip_smoke.Card()
    libs = build(Path(__file__).resolve().parents[1] / "build"
                 / "rglru_variants")
    bad = []
    for shape in TIMED + CHECKED:
        b, s, d = shape
        a, x, h0 = chip_smoke.rglru_inputs(b, s, d, 61, zero_h0=s > 8)
        rout, rlast = rglru_scan_ref(a, x, h0)
        rec = {"B": b, "S": s, "D": d, "bit_equal": {}}
        for name, lib in libs.items():
            out, last = scan(lib, a, x, h0)
            torch.cuda.synchronize()
            rec["bit_equal"][name] = ok = bool(
                torch.equal(out, rout) and torch.equal(last, rlast))
            if not ok:
                bad.append((name, shape))
        if shape in TIMED:
            nbytes = 4 * (3 * b * s * d + 2 * b * d)
            rec["bound_ms"], rec["bound_by"] = card.bound(nbytes,
                                                          2 * b * s * d)
            rec["device_ms"] = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    rec["device_ms"][name].append(chip_smoke.device_ms(
                        lambda lib=libs[name]: scan(lib, a, x, h0),
                        "rglru", reps=args.reps))
        rec.update(device=card.name, nvidia_smi=card.smi)
        print(json.dumps(rec), flush=True)
        del a, x, h0, rout, rlast
        torch.cuda.empty_cache()
    if bad:
        print(f"rglru_variants: not bit-equal: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
