"""The training CLI: the DANA pod-round step on one device.

Pods are DANA's asynchronous workers; one step executes one master
round (``launch.steps``).  With one pod the step is exactly Nesterov
(the paper's Algorithm 5).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 100 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --pods 2 --batch 8 --seq 512 --steps 6 --ckpt results/ckpt

The flags are the JAX package's ``repro.launch.train``'s, with the same
defaults, plus ``--device`` (cuda unless asked for the CPU); a host mesh
(``--mesh`` other than 1x1, ``--devices``) is ROADMAP A8 and raises.
Parameters are drawn from ``--seed`` and kept in float32 (theta, one
momentum per pod, v0); each pod computes in bfloat16.  ``--ckpt`` names
a directory (step-numbered checkpoints, retention, a metrics sidecar)
or, ending in ``.npz``, one file; a run resumes from what it finds
there.  Checkpoints are the JAX package's format.  ``main`` prints the
JAX CLI's lines and returns (first, last): the mean loss of the first
and of the last five steps.

An enc-dec config (seamless-m4t-large-v2) trains on the task's tokens as
decoder targets and on encoder frames ``enc_embeds`` (B, min(
max_encoder_len, --seq), d) ~ 0.02 N(0, 1) in bfloat16, drawn for each
step from a numpy stream of (seed, step) (``encoder_frames``).  The JAX
CLI passes tokens alone and fails on such a config.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager, load_pytree, save_pytree
from ..configs import get_config
from ..core.schedules import Schedule
from ..core.types import tree_leaves
from ..data.synthetic import LMTask, _fold
from ..models.api import build_model
from .steps import TrainSettings, build_train_step, init_train_state


def encoder_frames(cfg, batch: int, seq: int, seed: int, step: int,
                   device):
    """Step ``step``'s encoder input for an enc-dec config: (batch,
    min(max_encoder_len, seq), d) ~ 0.02 N(0, 1), bfloat16, from the
    stream ``_fold(seed, 303, step)``."""
    rng = _fold(seed, 303, step)
    frames = rng.normal(size=(batch, min(cfg.max_encoder_len, seq),
                              cfg.d_model)) * 0.02
    return torch.as_tensor(frames.astype(np.float32),
                           device=device).to(torch.bfloat16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", default=False)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--devices", type=int, default=None,
                    help="a host mesh of N devices (not ported: raises)")
    ap.add_argument("--mesh", default=None,
                    help="'DxM' mesh shape (only 1x1 is ported)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods: DANA's asynchronous workers, one master "
                         "round a step")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.devices is not None or args.mesh not in (None, "1x1"):
        raise NotImplementedError("a host mesh (--devices, --mesh other "
                                  "than 1x1) is not ported yet: ROADMAP A8")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512))
    model = build_model(cfg)
    dev = torch.device(args.device)
    settings = TrainSettings(lr=args.lr, momentum=args.momentum)
    sched = Schedule(base_lr=args.lr, num_workers=max(args.pods, 1),
                     warmup_steps=args.warmup,
                     milestones=(int(0.8 * args.steps),))
    task = LMTask(vocab_size=cfg.vocab_size, seq_len=args.seq,
                  batch_size=args.batch, seed=args.seed, device=args.device)
    step = build_train_step(model, settings, sched)
    state = init_train_state(model,
                             torch.Generator(device=dev).manual_seed(
                                 args.seed), args.pods, dev)
    mesh = ({"pod": args.pods} if args.pods > 1 else {}) | \
        {"data": 1, "model": 1}
    nparams = sum(l.numel() for l in tree_leaves(state["theta"]))
    print(f"mesh: {mesh}  arch: {cfg.name} ({nparams/1e6:.1f}M params)  "
          f"device: {dev}")

    start = 0
    mgr = None
    if args.ckpt and not args.ckpt.endswith(".npz"):
        mgr = CheckpointManager(args.ckpt)         # directory mode
        restored, _ck_step = mgr.restore(state)
        if restored is not None:
            state, start = restored, int(restored["t"])
            print(f"resumed from {args.ckpt} at step {start}")
    elif args.ckpt and os.path.exists(args.ckpt):
        state = load_pytree(args.ckpt, like=state)
        start = int(state["t"])
        print(f"resumed from {args.ckpt} at step {start}")

    t0 = time.time()
    losses = []
    saved = None
    for i in range(start, args.steps):
        batch = {"tokens": task.batch(0, i)}
        if cfg.is_encdec:
            batch["enc_embeds"] = encoder_frames(cfg, args.batch, args.seq,
                                                 args.seed, i, dev)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            dt = time.time() - t0
            tput = (i + 1 - start) * args.batch * args.seq / dt
            print(f"step {i+1:5d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{tput:.0f} tok/s", flush=True)
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            saved = _save(mgr, args.ckpt, i + 1, state)
            if mgr is not None:
                mgr.log_metrics(i + 1, loss=losses[-1],
                                lr=float(metrics["lr"]))

    if args.ckpt and saved != args.steps:
        # the JAX CLI saves again here; the state is the one just saved
        # when the last step was a checkpoint step
        _save(mgr, args.ckpt, args.steps, state)
    first = float(np.mean(losses[:5])) if len(losses) >= 5 else losses[0]
    last = float(np.mean(losses[-5:]))
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"({args.steps - start} steps, {time.time()-t0:.1f}s)")
    return first, last


def _save(mgr, path, step, state):
    if mgr is not None:
        mgr.save(step, state)
    else:
        save_pytree(path, state)
    return step


if __name__ == "__main__":
    main()
