"""Batched serving: prefill a batch of prompts, decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2 --reduced --device cpu

Every config serves: falcon-mamba-7b, recurrentgemma-9b, the dense
configs (the qwen2s and chatglm3-6b with its 2-D RoPE), the MoE configs
(granite-moe-3b-a800m, llama4-scout-17b-a16e), qwen2-vl-7b (M-RoPE and a
vision prefix) and the enc-dec seamless-m4t-large-v2.  As in the JAX
package, a vision config's prompts follow a zero prefix of
``modality_tokens`` embeddings, an M-RoPE config takes the (3, B, P + S)
positions, an enc-dec config's encoder reads zero frame embeddings of
length min(max_encoder_len, S), and the cache holds S + gen positions
(the prompt's, not the prefix's: a prefixed prefill keeps its last S +
gen positions).
``--window`` caps every attention cache at that many positions and
makes the dense layers attend within it (recurrentgemma's local layers
keep their own window of ``cfg.window`` either way).

Parameters are drawn from ``--seed`` and stored in bfloat16 (the JAX
CLI casts every float32 leaf to bfloat16; here each leaf is drawn in
float32 one layer at a time and cast as it is written), prompts from the
same numpy stream as the JAX CLI's.  Runs on ``cuda`` unless
``--device cpu``.  Of the JAX CLI's flags, ``--devices`` (a host mesh)
has no counterpart.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..models.api import build_model
from ..models.attention import CacheSpec


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(logits):
    return torch.argmax(logits[:, -1, :], -1).to(torch.int32)[:, None]


def serve_batch(cfg, prompts):
    """The prefill batch of ``prompts`` (B, S): a zero modality prefix
    (B, ``modality_tokens``, d) in bfloat16 for a vision config, the
    (3, B, P + S) positions for M-RoPE, and zero encoder frames (B,
    min(max_encoder_len, S), d) in bfloat16 for an enc-dec config."""
    b, s = prompts.shape
    batch = {"tokens": prompts}
    total = s
    if cfg.modality == "vision":
        batch["embeds"] = torch.zeros((b, cfg.modality_tokens, cfg.d_model),
                                      dtype=torch.bfloat16,
                                      device=prompts.device)
        total += cfg.modality_tokens
    if cfg.rope == "mrope":
        batch["positions"] = torch.arange(
            total, dtype=torch.int32, device=prompts.device).expand(
                3, b, total)
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.zeros(
            (b, min(cfg.max_encoder_len, s), cfg.d_model),
            dtype=torch.bfloat16, device=prompts.device)
    return batch


def generate(model, params, prompts, gen_len: int,
             window: int | None = None):
    """Greedy batched generation; returns (tokens (B, gen), stats)."""
    b, s = prompts.shape
    capacity = s + gen_len if window is None else min(window, s + gen_len)
    spec = CacheSpec(capacity=capacity, window=window)
    dev = prompts.device

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, serve_batch(model.cfg, prompts),
                                  spec)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = _greedy(logits)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        logits, cache = model.decode_step(params, tok, cache, spec)
        tok = _greedy(logits)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "prefill_tok_per_s": b * s / max(t_prefill, 1e-9),
        "decode_tok_per_s": b * max(gen_len - 1, 1) / max(t_decode, 1e-9),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--reduced", action="store_true", default=False)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, device=dev, dtype=torch.bfloat16)

    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)

    toks, stats = generate(model, params, prompts, args.gen,
                           window=args.window)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    for k, v in stats.items():
        print(f"  {k}: {v:.3f}")
    print("first sequences:", toks[:2].cpu().tolist())
    return stats


if __name__ == "__main__":
    main()
