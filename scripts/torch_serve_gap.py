#!/usr/bin/env python3
"""How far prefill + decode lands from forward, in bf16 and in f32, at a
config's full width on one GPU.

    python3 scripts/torch_serve_gap.py [--arch qwen2-vl-7b] [--arch ...]
        [--batch 4] [--prompt 512]

For each config (drawn as ``chip_smoke.py``'s serve phases draw it: full
width and depth, weights from a seed), ``chip_smoke.decode_vs_forward``
and ``gap_stats``, the check of its ``generate_phase``: prefill the
prompts (after the zero vision prefix of a vision config, with its
M-RoPE positions), decode the greedy token, and hold the step's logits
against forward over prompt + token.  It runs the check in bf16 (the
serve type), in bf16 without the vision prefix (tokens alone, positions
from 0), and with float32 parameters and activations (the KV cache
stays bf16, as in the JAX package), and prints one JSON line a run: the
largest gap, its RMS and how many logits lie past
``chip_smoke.SERVE_TOL``.  The MoE configs run at capacity E / top_k,
where nothing drops.  Exits 2 without a CUDA device.
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (puts src/ on the path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--batch", type=int, default=chip_smoke.SERVE_BATCH)
    ap.add_argument("--prompt", type=int, default=chip_smoke.SERVE_PROMPT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_gap: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    for arch in args.arch or [chip_smoke.VL_ARCH]:
        cfg = get_config(arch)
        if cfg.num_experts:
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts / cfg.experts_per_tok)
        prompts = chip_smoke.serve_prompts(cfg, 0, args.batch, args.prompt)
        for dtype in (torch.bfloat16, torch.float32):
            model = build_model(cfg, dtype)
            params = model.init(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda", dtype=dtype)
            runs = [("prefix", model)]
            if cfg.modality == "vision" and dtype == torch.bfloat16:
                runs.append(("no_prefix", build_model(
                    dataclasses.replace(cfg, modality=None), dtype)))
            for label, m in runs:
                with torch.no_grad():
                    _, step, full, _ = chip_smoke.decode_vs_forward(
                        m, params, prompts)
                print(json.dumps({
                    "phase": "serve_gap", "arch": arch,
                    "dtype": str(dtype).replace("torch.", ""),
                    "inputs": label, "batch": args.batch,
                    "prompt": args.prompt, "logits": step.numel(),
                    **chip_smoke.gap_stats(step, full),
                    "logit_rms": float(torch.sqrt(torch.mean(full * full))),
                    "tolerance": chip_smoke.SERVE_TOL,
                    "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
            del model, params, runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
