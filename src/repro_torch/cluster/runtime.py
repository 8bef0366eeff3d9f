"""Cluster orchestration: ``run_cluster`` mirrors ``run_simulation``.

Same signature shape, same ``History`` result, same ``Algorithm`` objects
— but executed by real threads through a mailbox instead of a
single-threaded event loop.  In ``deterministic`` mode the run is
step-for-step identical to the engine (tested bit for bit); ``paced`` and
``free`` modes trade that for actual wall-clock concurrency.

The port runs the thread backend, with one master or (``shards > 1``)
the row-sharded master of ``cluster/sharded.py``, its shards threads on
one card; ``hot_rows`` declares per-worker hot row ranges for pull-only
requests.  The one option of the JAX package's ``ClusterConfig`` the
port does not implement yet, ``backend="process"``, raises
``NotImplementedError`` naming its ROADMAP.md item (A5).
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Any, Callable

import torch

from ..core.algorithms import Algorithm
from ..core.gamma import GammaModel
from ..core.metrics import History
from ..core.types import Pytree, tree_map
from ..kernels.flat_update import kernel_eligible
from ..obs import trace
from ..obs.metrics import (MetricsRegistry, SnapshotPublisher,
                           history_observer, serve_instruments)
from .clock import VirtualClock
from .faults import FaultInjector, FaultPlan
from .mailbox import Mailbox
from .master import Master
from .sharded import ShardedMaster
from .worker import TurnGate, Worker

MODES = ("deterministic", "paced", "free")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    num_workers: int = 8
    total_grads: int = 1000
    eval_every: int = 100
    mode: str = "deterministic"
    coalesce: int = 1              # max messages per batched master receive
    exec_model: GammaModel = GammaModel()
    time_scale: float = 1e-3       # model time unit -> seconds (paced mode)
    faults: FaultPlan | None = None
    record_telemetry: bool = True
    use_kernel: bool | None = None  # None = auto (flat path, live modes)
    # with use_kernel=True: False runs the legacy per-message dana_update
    # kernel on trees (DANA-Zero only) instead of the flat path
    # (``Master``'s own switch, here so run_cluster can reach it)
    flat: bool | None = None
    shards: int = 1                 # row-range master shards (flat path)
    mailbox_capacity: int = 0       # 0 = unbounded
    rpc_timeout: float = 120.0
    # per-worker hot flat-row ranges for pull-only requests (num_workers
    # entries, each None or (r0, r1)); masters that cannot honour a range
    # (tree path, members whose send writes state) serve the full view
    hot_rows: tuple | None = None
    # row-sharded placement: optional initial shard row ranges, and
    # online busy_s-driven rebalancing at eval watermarks
    shard_ranges: tuple | None = None
    rebalance: bool = False
    rebalance_threshold: float = 1.1
    backend: str = "thread"         # "process": ROADMAP A5
    # pin the message schedule to strict round-robin worker order (live
    # modes): makes a run schedule-deterministic
    pin_schedule: bool = False
    # worker pull-ahead (live modes): each worker keeps up to this many
    # pushes in flight, computing its next gradient against the newest
    # reply it HAS, at the cost of exactly `depth` extra designed
    # staleness.  0 = synchronous push-pull; deterministic mode needs 0.
    pipeline_depth: int = 0
    device: str = "cuda"


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md "
                              f"item {item}")


def _validate(algo: Algorithm, cfg: ClusterConfig) -> None:
    if cfg.mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {cfg.mode!r}")
    if cfg.num_workers < 1 or cfg.total_grads < 1:
        raise ValueError("need at least one worker and one gradient")
    if cfg.shards < 1:
        raise ValueError(f"need shards >= 1, got {cfg.shards}")
    if cfg.backend not in ("thread", "process"):
        raise ValueError(f"backend must be 'thread' or 'process', "
                         f"got {cfg.backend!r}")
    if cfg.pin_schedule and cfg.mode == "deterministic":
        raise ValueError("pin_schedule is a live-mode pin (deterministic "
                         "mode already serializes the schedule through "
                         "the virtual clock)")
    if cfg.pin_schedule and cfg.faults is not None \
            and cfg.faults.any_dropout:
        raise ValueError("pin_schedule cannot combine with dropout (an "
                         "offline worker would wedge the turn gate)")
    if cfg.pipeline_depth < 0:
        raise ValueError(f"pipeline_depth must be >= 0, "
                         f"got {cfg.pipeline_depth}")
    if cfg.pipeline_depth > 0 and cfg.mode == "deterministic":
        raise ValueError("pipeline_depth > 0 requires a live mode "
                         "(deterministic mode serializes every RPC "
                         "through the virtual clock, so pull-ahead "
                         "would deadlock it); use paced or free")
    if cfg.backend == "process":
        _not_ported("the process backend (backend='process')", "A5")
    if algo.name == "ssgd":
        raise ValueError(
            "ssgd needs the engine's synchronous barrier (per-message "
            "receive would silently change its semantics); use "
            "run_simulation, or an asynchronous algorithm here")
    if (cfg.mode == "deterministic" and cfg.faults is not None
            and cfg.faults.any_dropout):
        raise ValueError("dropout/rejoin is not supported in deterministic "
                         "mode (it would leave the virtual clock); use "
                         "stalls, or a live mode")
    if cfg.rebalance and cfg.shards < 2:
        raise ValueError("rebalance=True requires shards > 1 (there is "
                         "nothing to move rows between)")
    if cfg.shard_ranges is not None and cfg.shards < 2:
        raise ValueError("shard_ranges requires shards > 1")
    if cfg.shards > 1 and cfg.use_kernel is False:
        raise ValueError("shards > 1 requires the flat kernel master "
                         "(use_kernel must not be False)")
    if cfg.shards > 1 and cfg.flat is False:
        raise ValueError("shards > 1 requires the flat kernel master "
                         "(flat must not be False: the legacy per-leaf "
                         "kernel has no row ranges)")
    if cfg.hot_rows is not None and len(cfg.hot_rows) != cfg.num_workers:
        raise ValueError(f"hot_rows needs one entry per worker "
                         f"({cfg.num_workers}), got {len(cfg.hot_rows)}")


def _hot_rows(cfg: ClusterConfig, master, sharded: bool):
    """Per-worker (hot row range, merge function) from ``cfg.hot_rows``:
    ranges checked against the layout; none under rebalancing (ranges
    move, so those runs pull full views).  A merge patches a partial
    reply into a COPY of the worker's cached view."""
    n = cfg.num_workers
    hot_rows, merges = [None] * n, [None] * n
    if cfg.hot_rows is None:
        return hot_rows, merges
    if not master.state_is_flat:
        raise ValueError("hot_rows requires the flat kernel master "
                         "(use_kernel must not be False)")
    rows_total = master._flat_algo.spec.rows
    rebalancing = sharded and master.rebalancer is not None
    for wid, hr in enumerate(cfg.hot_rows):
        if hr is None:
            continue
        r0, r1 = int(hr[0]), int(hr[1])
        if not 0 <= r0 < r1 <= rows_total:
            raise ValueError(f"hot_rows[{wid}]={hr} invalid: need "
                             f"0 <= r0 < r1 <= {rows_total} "
                             f"(r1 bound inclusive)")
        if rebalancing:
            continue
        if sharded:
            plans = tuple((s, max(r0, s0) - s0, min(r1, s1) - s0)
                          for s, (s0, s1) in enumerate(master.ranges)
                          if max(r0, s0) < min(r1, s1))

            def merge(old, piece, plans=plans):
                new = list(old)
                for s, a, b in plans:
                    new[s] = new[s].clone()
                    new[s][a:b] = piece[s]
                return tuple(new)
        else:
            def merge(old, piece, a=r0, b=r1):
                new = old.clone()
                new[a:b] = piece
                return new
        hot_rows[wid], merges[wid] = (r0, r1), merge
    return hot_rows, merges


def run_cluster(
    algo: Algorithm,
    grad_fn: Callable[[Pytree, Any], Pytree],
    params0: Pytree,
    next_batch: Callable[[int, int], Any],
    cfg: ClusterConfig,
    eval_fn: Callable[[Pytree], Any] | None = None,
    stats_out: dict | None = None,
    metrics: MetricsRegistry | None = None,
) -> History:
    """Run one threaded parameter-server training session on
    ``cfg.device``.

    Arguments match ``repro_torch.core.engine.run_simulation``
    (``params0`` is copied to the device; batches must already live
    there); ``stats_out`` (optional dict) receives runtime statistics:
    applied message count, wall time, per-worker message counts and the
    coalescing histogram.

    ``metrics`` (optional ``repro_torch.obs.MetricsRegistry``) wires the
    observability layer in: telemetry rows feed the staleness/gap
    histograms through ``History.record``, the serve loop feeds the
    drained-batch-size histogram and pull/overflow counters, and a
    background ``SnapshotPublisher`` samples mailbox depth + master busy
    time off the hot path (its series lands in
    ``stats_out["obs_series"]``).  ``metrics=None`` leaves the hot path
    untouched.
    """
    _validate(algo, cfg)
    n = cfg.num_workers
    deterministic = cfg.mode == "deterministic"
    sharded = cfg.shards > 1
    use_kernel = cfg.use_kernel
    if use_kernel is None:
        # auto: the flat path in live modes (bit-equal to the tree path
        # for the elementwise members; dana-hetero and ga-asgd agree to
        # reduction-order tolerance); deterministic runs stay on the
        # tree path, as in the JAX package.  The sharded master exists
        # only on the flat path (it refuses ineligible algorithms).
        use_kernel = sharded or (not deterministic
                                 and kernel_eligible(algo))

    injector = (FaultInjector(cfg.faults, n, cfg.exec_model.batch_size)
                if cfg.faults is not None else None)
    stop = threading.Event()
    history = History()
    params = tree_map(lambda l: torch.as_tensor(l).to(cfg.device), params0)
    state = algo.init(params, n)
    t0 = time.perf_counter()

    if deterministic:
        time_fn = None                      # virtual time from the clock
        now_fn = None
    elif cfg.mode == "paced":
        def now_fn():                       # model-time units
            return (time.perf_counter() - t0) / cfg.time_scale
        time_fn = (lambda m: m.t_send)
    else:
        def now_fn():                       # wall seconds
            return time.perf_counter() - t0
        time_fn = (lambda m: m.t_send)

    # deterministic mode forces per-message receive so eval points and
    # event order match the engine exactly
    coalesce = 1 if deterministic else cfg.coalesce
    if sharded:
        shard_injectors = None
        if cfg.faults is not None:
            # reorder-only shard injectors (num_workers=0: no stall
            # streams); worker stalls and dropout stay on `injector`
            shard_injectors = [
                FaultInjector(cfg.faults, 0, cfg.exec_model.batch_size,
                              shard_id=s) for s in range(cfg.shards)]
        master = ShardedMaster(
            algo, state, shards=cfg.shards, history=history, stop=stop,
            total_grads=cfg.total_grads, coalesce=coalesce,
            record_telemetry=cfg.record_telemetry, eval_fn=eval_fn,
            eval_every=cfg.eval_every, injectors=shard_injectors,
            time_fn=time_fn, mailbox_capacity=cfg.mailbox_capacity,
            ranges=cfg.shard_ranges, rebalance=cfg.rebalance,
            rebalance_threshold=cfg.rebalance_threshold)
        mailbox = master.frontdoor
    else:
        mailbox = Mailbox(cfg.mailbox_capacity)
        master = Master(
            algo, state, mailbox=mailbox, history=history, stop=stop,
            total_grads=cfg.total_grads, coalesce=coalesce,
            use_kernel=use_kernel, flat=cfg.flat,
            record_telemetry=cfg.record_telemetry, eval_fn=eval_fn,
            eval_every=cfg.eval_every, injector=injector, time_fn=time_fn,
            pipeline_depth=cfg.pipeline_depth)
    del state, params

    # -- observability wiring (None-guarded: zero hot-path cost when off)
    publisher = None
    if metrics is not None:
        history.observer = history_observer(metrics)
        serve_mx = serve_instruments(metrics)
        for srv in (master.shards_ if sharded else (master,)):
            srv.metrics = serve_mx           # shared: per-thread cells
    if metrics is not None or trace.enabled:
        # gauge sources are lock-free reads (Mailbox.depth contract),
        # sampled by a background thread — never by cluster threads
        if sharded:
            sources = {}
            for s, (mb, srv) in enumerate(zip(master.mailboxes,
                                              master.shards_)):
                sources[f"mailbox_depth/shard{s}"] = \
                    (lambda mb=mb: mb.depth)
                sources[f"busy_s/shard{s}"] = (lambda srv=srv: srv.busy_s)
        else:
            sources = {"mailbox_depth": lambda: mailbox.depth,
                       "busy_s/master": lambda: master.busy_s}
        publisher = SnapshotPublisher(sources, registry=metrics)

    # warm-up pulls, in worker order on one thread (engine semantics)
    init_views = [master.initial_view(i) for i in range(n)]

    clock = None
    draw = None
    if deterministic:
        clock = VirtualClock(cfg.exec_model.sampler(n), n)
    elif cfg.mode == "paced":
        # one gamma stream per worker (np.random.Generator is not
        # thread-safe; statistics match, schedules don't need to)
        samplers = [
            dataclasses.replace(cfg.exec_model,
                                seed=cfg.exec_model.seed
                                + 1000003 * (wid + 1)).sampler(n)
            for wid in range(n)
        ]
        draw = (lambda wid: samplers[wid](wid))

    if sharded and master.rebalancer is not None:
        # rebalancing wire: ranges move at run time, so the worker ships
        # the FULL packed gradient (every shard gets the same buffer and
        # takes its current rows); its view is the tuple of slices
        spec = master.spec

        def worker_grad(fv, batch):
            return spec.pack(grad_fn(spec.unpack(spec.concat_rows(fv)),
                                     batch))
        if publisher is not None:
            # the rebalancer's busy_s signal: the published series
            master.rebalancer.series_fn = publisher.series
    elif sharded:
        # sharded wire: the worker joins its view from the shards'
        # slices and splits its packed gradient into per-shard row
        # slices (views of one contiguous buffer, no copy)
        spec, subs = master.spec, master.subs

        def worker_grad(fv, batch):
            g = spec.pack(grad_fn(spec.unpack(spec.concat_rows(fv)),
                                  batch))
            return tuple(sub.take(g) for sub in subs)
    elif master.state_is_flat:
        # flat wire format: the worker unpacks its (R, 128) view and
        # packs its gradient on its own thread — the tree<->flat traffic
        # never runs on the master's hot path.  The unpacked view's
        # leaves are views of the worker's own reply buffer, never of
        # master state.
        spec = master._flat_algo.spec

        def worker_grad(fv, batch):
            return spec.pack(grad_fn(spec.unpack(fv), batch))
    else:
        worker_grad = grad_fn
    hot_rows, merges = _hot_rows(cfg, master, sharded)

    # load the kernel libraries (and make the declared hot-row views)
    # before any worker or the serve loop runs
    master.warm(hot_ranges=tuple(sorted(
        {hr for hr in hot_rows if hr is not None})))

    gate = TurnGate(n, stop) if cfg.pin_schedule else None
    workers = [
        Worker(wid, master=master, mailbox=mailbox, grad_fn=worker_grad,
               next_batch=next_batch, stop=stop, mode=cfg.mode,
               init_view=init_views[wid], clock=clock, draw=draw,
               now_fn=now_fn, time_scale=cfg.time_scale, injector=injector,
               telemetry=cfg.record_telemetry, rpc_timeout=cfg.rpc_timeout,
               hot_rows=hot_rows[wid], merge_view=merges[wid],
               gate=gate, pipeline_depth=cfg.pipeline_depth)
        for wid in range(n)
    ]
    del init_views

    master_thread = threading.Thread(target=master.serve, name="ps-master",
                                     daemon=True)
    # CPython's default 5ms GIL switch interval turns every mailbox/reply
    # hand-off into a multi-millisecond convoy; the cluster is made of many
    # sub-millisecond critical sections, so ask for fast switching while
    # the run is live (restored afterwards).
    prev_switch = sys.getswitchinterval()
    sys.setswitchinterval(2e-4)
    try:
        if publisher is not None:
            publisher.start()
        master_thread.start()
        for w in workers:
            w.start()

        # the master join is bounded like the workers' below: the
        # deadline starts only once the serve loop has no legitimate
        # reason to keep running (stop raised, or every worker gone)
        m_deadline = None
        while master_thread.is_alive():
            master_thread.join(timeout=0.05)
            if not master_thread.is_alive():
                break
            if m_deadline is None:
                if stop.is_set() or not any(w.is_alive() for w in workers):
                    m_deadline = (time.monotonic()
                                  + max(cfg.rpc_timeout, 2.0))
            elif time.monotonic() > m_deadline:
                stop.set()
                master.reject_pending()
                err = (f" (master error: {master.error!r})"
                       if master.error else "")
                raise RuntimeError(f"master failed to shut down{err}")
        stop.set()
        if clock is not None:
            clock.stop()
        deadline = time.monotonic() + max(cfg.rpc_timeout, 10.0)
        for w in workers:
            while w.is_alive():
                master.reject_pending()   # unblock stragglers mid-push
                w.join(timeout=0.05)
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"worker {w.wid} failed to shut down")
    finally:
        sys.setswitchinterval(prev_switch)
        if publisher is not None:
            publisher.stop()

    errors = [("master", master.error)] if master.error else []
    errors += [(f"worker-{w.wid}", w.error) for w in workers if w.error]
    if errors:
        name, first = errors[0]
        raise RuntimeError(
            f"cluster run failed in {name} "
            f"({len(errors)} thread error(s))") from first

    if master.applied != cfg.total_grads:
        raise RuntimeError(f"cluster stopped early: applied "
                           f"{master.applied}/{cfg.total_grads} gradients")

    history.final_params = master.master_params()
    if stats_out is not None:
        t_end = time.perf_counter()
        applied_total = sum(k * v for k, v in
                            master.coalesce_counts.items())
        steady = None
        if master.steady_t is not None and t_end > master.steady_t:
            steady = ((master.applied - master._steady_mark)
                      / (t_end - master.steady_t))
        stats_out.update(
            applied=master.applied,
            wall_s=t_end - t0,
            updates_per_s=master.applied / max(t_end - t0, 1e-9),
            steady_updates_per_s=steady,
            master_busy_s=master.busy_s,
            master_updates_per_s=master.applied / max(master.busy_s, 1e-9),
            coalesce_counts=dict(sorted(master.coalesce_counts.items())),
            mean_coalesce=(applied_total
                           / max(sum(master.coalesce_counts.values()), 1)),
            grads_per_worker={w.wid: w.grads_sent for w in workers},
            use_kernel=use_kernel,
            flat=master.state_is_flat,
            shards=cfg.shards,
        )
        if sharded:
            stats_out["shard_applied"] = master.shard_applied
            stats_out["shard_busy_s"] = master.shard_busy_s
            stats_out["telemetry_dropped"] = master.tele_dropped
            if master.rebalancer is not None:
                stats_out["rebalance_moves"] = master.rebalance_moves
                stats_out["shard_ranges"] = master.current_ranges
        if publisher is not None:
            stats_out["obs_series"] = publisher.series()
    return history
