"""CLI for the port's threaded parameter-server cluster runtime.

  python -m repro_torch.launch.cluster --algo dana-zero \
      --workers 8 --grads 2000 --mode free --coalesce 4

  # deterministic mode, cross-validated against the discrete-event engine
  python -m repro_torch.launch.cluster --algo dana-zero \
      --workers 4 --grads 400 --mode deterministic --compare-engine

  # row-sharded multi-master (4 shard servers over the flat layout, on
  # threads); deterministic sharding stays bit for bit the engine
  python -m repro_torch.launch.cluster --algo dana-zero \
      --workers 8 --grads 2000 --mode free --coalesce 4 --shards 4

  # the elastic-averaging baseline (tree path, no kernel)
  python -m repro_torch.launch.cluster --algo easgd --mode free

  # fault injection: drop worker 2 between master steps 200 and 600,
  # 5% transient stalls, out-of-order delivery within the coalesce window
  python -m repro_torch.launch.cluster --mode paced --workers 8 \
      --grads 2000 --dropout 2:200:600 --stall-prob 0.05 --reorder-prob 0.2

  # observability: Chrome-trace JSON (open in ui.perfetto.dev) + a
  # metrics snapshot (staleness/gap histograms, mailbox depth series)
  python -m repro_torch.launch.cluster --mode free --workers 8 \
      --grads 2000 --coalesce 4 --trace results/cluster.trace.json \
      --metrics-out results/cluster.metrics.json

  # a real model's gradients through the parameter server: qwen2-1.5b
  # reduced with the tiny-LM overrides, 64-token sequences
  python -m repro_torch.launch.cluster --preset lm --model qwen2-1.5b \
      --workers 4 --grads 64 --mode deterministic --compare-engine

Runs on the GPU (``--device cuda``, the default) or, with ``--device
cpu``, on the CPU through the kernels' plain versions.  Run with
``PYTHONPATH=src`` from the repository root.  The flags are the JAX
package's ``repro.launch.cluster``'s, with the same defaults; the one
option the port does not implement yet (``--backend process``) raises.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..cluster import ClusterConfig, FaultPlan, run_cluster
from ..core.algorithms import REGISTRY, make_algorithm
from ..core.engine import SimulationConfig, run_simulation
from ..core.gamma import GammaModel
from ..core.schedules import Schedule
from ..core.types import HyperParams, tree_leaves
from ..data.synthetic import ClassificationTask, LMTask
from ..models.toy import ClassifierGradFn, make_classifier_fns


def _parse_dropout(specs):
    out = []
    for spec in specs or ():
        try:
            wid, start, end = (int(x) for x in spec.split(":"))
        except ValueError as e:
            raise SystemExit(
                f"--dropout expects WORKER:OUT_STEP:REJOIN_STEP, got "
                f"{spec!r}") from e
        out.append((wid, start, end))
    return tuple(out)


def _setup(args):
    if args.preset == "classifier":
        task = ClassificationTask(dim=args.dim, num_classes=10,
                                  batch_size=args.batch, seed=args.seed,
                                  device=args.device)
        dims = [args.dim, args.width, args.width, 10]
        init, _, make_eval = make_classifier_fns(dims)
        params0 = init(np.random.default_rng(args.seed), device=args.device)
        return (params0, ClassifierGradFn(dims), task.batch,
                make_eval(task.eval_batch()))
    # real-model preset: any registered config name, reduced to smoke
    # scale.  ModelGradFn carries (config name, overrides) instead of a
    # built model, as the JAX package's does for its process backend.
    from ..models.api import TINY_LM_OVERRIDES, ModelGradFn
    over = dict(TINY_LM_OVERRIDES) if args.model == "qwen2-1.5b" else {}
    grad_fn = ModelGradFn(args.model, overrides=over, mesh_shape=(1, 1))
    model = grad_fn.build_model()
    task = LMTask(vocab_size=model.cfg.vocab_size, seq_len=64,
                  batch_size=args.batch, seed=args.seed, device=args.device)
    params0 = grad_fn.init(torch.Generator(device=args.device).manual_seed(
        args.seed), device=args.device)
    ev = task.eval_batch(8)

    @torch.no_grad()
    def eval_fn(params):
        return model.loss(params, {"tokens": ev})
    return params0, grad_fn, task.batch, eval_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", default="dana-zero",
                    choices=sorted(REGISTRY))
    ap.add_argument("--preset", default="classifier",
                    choices=["classifier", "lm"],
                    help="classifier: the MLP; lm: a real model's LM "
                         "loss on the synthetic Markov task (--model)")
    ap.add_argument("--model", default="qwen2-1.5b",
                    help="config name for --preset lm (any ported "
                         "ArchConfig; reduced to smoke scale, with the "
                         "tiny-LM overrides for the default config)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--grads", type=int, default=1000)
    ap.add_argument("--mode", default="free",
                    choices=["deterministic", "paced", "free"])
    ap.add_argument("--coalesce", type=int, default=4)
    ap.add_argument("--shards", type=int, default=1,
                    help="row-range master shards (flat kernel path "
                         "only; threads on one device)")
    ap.add_argument("--backend", default="thread",
                    choices=["thread", "process"],
                    help="process is not ported (raises)")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="worker pull-ahead depth (live modes): keep up "
                         "to this many pushes in flight per worker — "
                         "hides the RPC round trip at the cost of that "
                         "much extra designed staleness (0 = "
                         "synchronous push-pull)")
    ap.add_argument("--pin-schedule", action="store_true",
                    help="pin live-mode pushes to strict round-robin "
                         "worker order")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--warmup-frac", type=float, default=0.0)
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--heterogeneous", action="store_true")
    ap.add_argument("--time-scale", type=float, default=1e-3)
    ap.add_argument("--no-kernel", action="store_true",
                    help="run the tree path (no flat kernel routing)")
    ap.add_argument("--no-telemetry", action="store_true")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stall-prob", type=float, default=0.0)
    ap.add_argument("--stall-scale", type=float, default=5.0)
    ap.add_argument("--dropout", nargs="*", default=None,
                    metavar="WORKER:OUT:REJOIN")
    ap.add_argument("--reorder-prob", type=float, default=0.0)
    ap.add_argument("--compare-engine", action="store_true",
                    help="(deterministic mode) also run the discrete-event "
                         "engine and report the max parameter difference")
    ap.add_argument("--out", default=None, help="JSON artifact path")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a Chrome-trace/Perfetto JSON of the run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics snapshot JSON (staleness/gap/"
                         "drain-k histograms, depth/busy series)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cpu: the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    if args.compare_engine and args.mode != "deterministic":
        raise SystemExit("--compare-engine requires --mode deterministic")

    params0, grad_fn, next_batch, eval_fn = _setup(args)
    sched = None
    if args.warmup_frac > 0:
        sched = Schedule(base_lr=args.lr, num_workers=args.workers,
                         warmup_steps=int(args.warmup_frac * args.grads))
    hp = HyperParams(lr=args.lr, momentum=args.momentum)
    gm = (GammaModel.heterogeneous_env(seed=args.seed)
          if args.heterogeneous else GammaModel.homogeneous(seed=args.seed))
    faults = None
    if args.stall_prob or args.dropout or args.reorder_prob:
        faults = FaultPlan(seed=args.seed, stall_prob=args.stall_prob,
                           stall_scale=args.stall_scale,
                           dropout=_parse_dropout(args.dropout),
                           reorder_prob=args.reorder_prob)
    cfg = ClusterConfig(
        num_workers=args.workers, total_grads=args.grads,
        eval_every=args.eval_every, mode=args.mode,
        coalesce=args.coalesce, shards=args.shards, exec_model=gm,
        time_scale=args.time_scale, faults=faults,
        record_telemetry=not args.no_telemetry,
        use_kernel=False if args.no_kernel else None,
        backend=args.backend, pin_schedule=args.pin_schedule,
        pipeline_depth=args.pipeline_depth, device=args.device)
    algo = make_algorithm(args.algo, hp, sched)
    stats: dict = {}
    registry = None
    if args.metrics_out:
        from ..obs import MetricsRegistry
        registry = MetricsRegistry()
    if args.trace:
        from ..obs import trace
        trace.enable()
    try:
        hist = run_cluster(algo, grad_fn, params0, next_batch, cfg,
                           eval_fn, stats_out=stats, metrics=registry)
    finally:
        if args.trace:
            from ..obs import trace, validate_chrome_trace
            trace.disable()
            obj = trace.export(args.trace)
            errs = validate_chrome_trace(obj)
            spans = sum(1 for e in obj["traceEvents"] if e["ph"] == "X")
            print(f"[trace] {args.trace}: {len(obj['traceEvents'])} "
                  f"events, {spans} spans, "
                  f"{'VALID' if not errs else errs[:3]}")
    if registry is not None:
        registry.to_json(args.metrics_out,
                         extra={"series": stats.get("obs_series", {})})
        print(f"[metrics] {args.metrics_out}: "
              f"{', '.join(registry.names())}")
    summary = hist.summary()
    # obs_series (the publisher's full time series) lives in the
    # --metrics-out artifact, not the console summary
    summary.update({k: v for k, v in stats.items()
                    if k not in ("grads_per_worker", "obs_series")})
    summary["device"] = args.device
    print("== cluster run ==")
    for k, v in summary.items():
        print(f"  {k}: {v}")
    print(f"  grads_per_worker: {stats['grads_per_worker']}")

    if args.compare_engine:
        algo2 = make_algorithm(args.algo, hp, sched)
        sim = SimulationConfig(num_workers=args.workers,
                               total_grads=args.grads,
                               eval_every=args.eval_every, exec_model=gm,
                               record_telemetry=not args.no_telemetry,
                               use_kernel=stats["flat"], device=args.device)
        h2 = run_simulation(algo2, grad_fn, params0, next_batch, sim,
                            eval_fn)
        diff = max(float((a - b).abs().max())
                   for a, b in zip(tree_leaves(hist.final_params),
                                   tree_leaves(h2.final_params)))
        print("== engine cross-validation ==")
        print(f"  max param diff vs run_simulation: {diff:.3e}  "
              f"({'BIT-EXACT' if diff == 0.0 else 'MISMATCH'})")
        summary["engine_max_param_diff"] = diff

    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary,
                       "eval_loss": hist.eval_loss,
                       "eval_step": hist.eval_step}, f, indent=1,
                      default=float)
        print(f"[saved] {args.out}")
    return summary


if __name__ == "__main__":
    main()
