"""Row-sharded multi-master parameter server on the flat layout.

The paper attributes its scaling ceiling to the single parameter server
(App. C.1): above about 20 workers the master bounds throughput.  Every
update rule of the flat-eligible family but one is elementwise per row,
so the same flat buffers split into S contiguous row ranges
(``FlatSpec.row_ranges``) and S shard servers, each applying every
worker message to its own rows, reproduce the single master: joined in
range order, the shard states equal the single flat master's bit for
bit whenever the shards apply the same message sequence (deterministic
mode always).

Here the shards are threads on one card.  Each runs the master's serve
loop (``master.run_serve_loop``: drain, truncate, reorder, chunk, apply,
reply) over its own mailbox; each drained batch is one launch of the
batched update kernel over the shard's rows (``flat_update_batch``),
and each reply slice and hot-row pull one ``send_view`` over them.  All
launches go to the current (default) stream, so the device runs them in
the order the threads issued them; a reply slice is a kernel output of
its own, so gathering S slices needs no event.

Protocol: workers push a gradient ONCE, split into per-shard row slices
(views of one packed buffer); ``FanoutMailbox`` fans the message out
atomically and ``_ReplyGroup`` gathers the S view slices into one
reply.  Shard clocks are barrier-free; the atomic fan-out and FIFO
queues still give every shard the same message sequence.  Per-shard
reorder injection is the only thing that makes shard orders differ.

Cross-shard aggregation happens off the hot path:

* telemetry: each shard adds its rows' partial ``sum d^2`` / ``sum g^2``
  to the message's group; the row is recorded once all S are in;
* eval: each shard contributes a copy of its theta slice when its
  applied count crosses an eval boundary (fused chunks never straddle
  one), and the eval runs on the assembled theta once all S slices for
  that boundary are in.

One member needs cross-shard data ON the hot path: ga-asgd scales each
gradient by the norm of ``theta - sent_i`` over ALL rows.  Its shards
apply one message at a time and exchange two scalar partial sums per
message (the gap before applying, the update norm for the ``avg_step``
EMA after) through ``_NormExchange``.  Every shard sees the same
combined sums, but they add up in another order than the single
master's full sum, so sharded ga-asgd matches the single master to
float tolerance, not bit for bit (``eligibility_matrix``).  Its
per-message steps are plain torch ops, as the JAX package's are plain
jnp outside any Pallas kernel.

``RowRebalancer`` moves rows between adjacent shards at eval watermarks,
steered by the shards' ``busy_s``; where a row lives never changes its
arithmetic, so the final state is the unrebalanced run's bit for bit.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..core.algorithms import Algorithm
from ..core.metrics import History
from ..kernels.flat_update import (FlatAlgorithm, kernel_eligible,
                                   merge_flat, slice_flat, unpack_state)
from ..kernels.flat_update._build import LIB as FLAT_LIB
from .faults import FaultInjector
from .mailbox import FanoutMailbox, GradMsg, Mailbox, Reply
from .master import run_serve_loop


class _NormExchange:
    """Cross-shard scalar-sum exchange for ga-asgd's messages.

    Each message needs two sums over the shards' partials: phase 0 the
    gap partials ``sum d^2`` (before any shard applies), phase 1 the
    update-norm partials ``||v'||^2`` (before the avg_step EMA).  Shard
    ``sid`` publishes its partial for (seq, phase) in a preallocated
    ring (value first, generation stamp second: a reader that sees the
    stamp sees the value) and reads its peers' back with a bounded spin,
    then a sleeping wait.  A shard cannot run more than one message
    ahead of its peers (it needs their partials to finish a message), so
    a ring of 256 slots never wraps onto a live slot.  Every shard sums
    the partials in shard order in f32, so all get the same total.  A
    cluster stop aborts the wait."""

    WINDOW = 256
    SPINS = 2000

    def __init__(self, shards: int, stop: threading.Event):
        self.shards = shards
        self.stop = stop
        self.vals = np.zeros((self.WINDOW, 2, shards), np.float32)
        self.gen = np.zeros((self.WINDOW, 2, shards), np.int64)

    def combine(self, sid: int, seq: int, phase: int,
                partial: float) -> float:
        slot = seq % self.WINDOW
        g = seq // self.WINDOW + 1
        self.vals[slot, phase, sid] = np.float32(partial)
        self.gen[slot, phase, sid] = g          # publish AFTER the value
        row = self.gen[slot, phase]
        spins = 0
        while not (row >= g).all():
            spins += 1
            if spins <= self.SPINS:
                time.sleep(0)                   # yield the GIL
            else:
                if self.stop.is_set():
                    raise RuntimeError(
                        "norm exchange aborted: cluster stopping")
                time.sleep(5e-5)
        total = np.float32(0.0)
        for s in range(self.shards):
            total = np.float32(total + self.vals[slot, phase, s])
        return float(total)


class RowRebalancer:
    """Online row-range rebalancing between adjacent shards.

    Every ``every`` applied messages (the eval watermarks: no fused chunk
    straddles them, so all shards pause at the same applied count) the
    first shard to reach the watermark reads the shards' ``busy_s``
    (through ``series_fn``, the observability publisher, when wired) and
    decides at most ONE move: the busiest shard gives a row-aligned
    block from its edge next to its less busy neighbour.  The decision is
    cached per watermark, so every shard sees the same plan; the donor
    slices the rows off its state (``slice_flat``) and leaves them in a
    slot, the receiver waits for them and joins them (``merge_flat``).
    Gap-aware members are refused (their exchange assumes fixed
    ranges)."""

    def __init__(self, owner: "ShardedMaster", *, every: int,
                 threshold: float = 1.1, series_fn=None):
        self.owner = owner
        self.every = max(1, every)
        self.threshold = float(threshold)
        self.series_fn = series_fn
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._plans: dict = {}              # watermark -> plan | None
        self._pieces: dict = {}             # watermark -> donated rows
        self.moves: list[tuple] = []        # (watermark, donor, recv, n)

    def _busy(self) -> list[float]:
        busy = [float(srv.busy_s) for srv in self.owner.shards_]
        if self.series_fn is not None:
            try:
                series = self.series_fn()
                for s in range(len(busy)):
                    pts = series.get(f"busy_s/shard{s}")
                    if pts:
                        busy[s] = float(pts[-1][1])
            except Exception:  # noqa: BLE001 - observation must not kill
                pass
        return busy

    def _decide(self):
        srvs = self.owner.shards_
        busy = self._busy()
        donor = max(range(len(busy)), key=lambda s: busy[s])
        cands = [s for s in (donor - 1, donor + 1) if 0 <= s < len(busy)]
        recv = min(cands, key=lambda s: busy[s])
        if busy[donor] < self.threshold * max(busy[recv], 1e-12):
            return None
        align = self.owner.spec.row_align
        rows_d = srvs[donor].r1 - srvs[donor].r0
        rows_r = srvs[recv].r1 - srvs[recv].r0
        # a quarter of the row imbalance, row-aligned, leaving the donor
        # at least one aligned block
        move = max((rows_d - rows_r) // 4 // align * align, 0)
        move = min(move, (rows_d - align) // align * align)
        if move < align:
            return None
        return (donor, recv, move)

    def _plan_for(self, wm: int):
        with self._lock:
            if wm not in self._plans:
                self._plans[wm] = self._decide()
            return self._plans[wm]

    def at_watermark(self, srv: "_ShardServer"):
        wm = srv.applied
        if wm % self.every or wm >= self.owner.total:
            return
        plan = self._plan_for(wm)
        if plan is None:
            return
        donor, recv, move = plan
        if srv.sid == donor:
            self._donate(srv, wm, recv, move)
        elif srv.sid == recv:
            self._receive(srv, wm, donor)

    def _donate(self, srv, wm, recv, move):
        # re-clamp against the donor's rows now: a plan made by a shard
        # that ran ahead of an earlier move may be stale
        align = self.owner.spec.row_align
        rows = srv.r1 - srv.r0
        move = min(move, (rows - align) // align * align)
        if move < align:
            piece = None                # no move; unblock the receiver
        elif recv < srv.sid:            # the leading edge
            piece = slice_flat(srv.state, 0, move)
            srv.state = slice_flat(srv.state, move, rows)
            srv.r0 += move
        else:                           # the trailing edge
            piece = slice_flat(srv.state, rows - move, rows)
            srv.state = slice_flat(srv.state, 0, rows - move)
            srv.r1 -= move
        with self._cond:
            self._pieces[wm] = piece
            if piece is not None:
                self.moves.append((wm, srv.sid, recv, move))
            self._cond.notify_all()

    def _receive(self, srv, wm, donor):
        with self._cond:
            while wm not in self._pieces:
                if self.owner.stop.is_set():
                    return
                self._cond.wait(timeout=0.05)
            piece = self._pieces.pop(wm)
        if piece is None:
            return
        move = int(piece["theta"].shape[-2])
        if donor < srv.sid:             # rows arrive before this range
            srv.state = merge_flat([piece, srv.state])
            srv.r0 -= move
        else:                           # rows arrive after it
            srv.state = merge_flat([srv.state, piece])
            srv.r1 += move


class _ShardServer:
    """One row-range shard: a single-threaded master over rows [r0, r1).
    Its serve loop is the master's (``run_serve_loop``); its state is a
    row slice, and telemetry and eval go to the owner as partials.  Under
    rebalancing [r0, r1) moves: gradients then arrive full and each
    batch takes the shard's current rows."""

    def __init__(self, sid: int, owner: "ShardedMaster", r0: int, r1: int,
                 state: dict, mailbox: Mailbox,
                 injector: FaultInjector | None):
        self.sid = sid
        self.owner = owner
        self.r0, self.r1 = r0, r1
        self.state = state              # flat dict of rows [r0, r1)
        self.mailbox = mailbox
        self.injector = injector
        self.fa = owner._flat_algo
        self.stop = owner.stop
        self.total = owner.total
        self.coalesce = owner.coalesce
        self.telemetry = owner.record_telemetry
        # fused chunks never straddle an eval (or rebalance) watermark:
        # all shards snapshot / move rows at the same applied counts
        self.eval_boundary = (owner.eval_every
                              if (owner._eval_fn is not None
                                  or owner.rebalancer is not None) else 0)
        self.applied = 0
        self._step = 0
        self._view_rows_fns: dict = {}
        self.coalesce_counts: dict[int, int] = {}
        self.busy_s = 0.0
        self.error: BaseException | None = None
        self.obs_cat = "shard"
        self.metrics = None

    @property
    def slab_info(self):
        st = self.state
        n_slabs = 2 if "sent" in st else 1
        return (int(st["v"].shape[0]), 2 * int(st["v"].shape[-2]) * n_slabs)

    def _apply_gap(self, work: list):
        """ga-asgd: the chunk one message at a time, two norm combines a
        message (each needs the combined norms of its predecessors)."""
        fa, ex, owner = self.fa, self.owner._gap_ex, self.owner
        for m in work:
            i, seq = m.worker_id, self.applied
            # one host sync a message for each partial, as in the JAX
            # package: the exchange adds host floats
            gap2 = ex.combine(self.sid, seq, 0,
                              float(fa.gap_partial(self.state, i)))
            st, hat, vn2, lr, vs, d2, g2 = fa.apply_gap_message(
                self.state, i, m.grad, gap2,
                m.view if self.telemetry else None)
            vn2 = ex.combine(self.sid, seq, 1, float(vn2))
            self.state = fa.finish_gap_message(st, vn2, lr, vs)
            t0 = self._step
            self._step = t0 + 1
            self.applied += 1
            if self.sid == 0 and self.applied == owner._steady_mark:
                owner.steady_t = time.perf_counter()
            if self.telemetry:
                m.group.add_telemetry(
                    self.sid, worker=m.worker_id, step=t0 + 1,
                    lag=t0 - m.view_step, t=owner._time_fn(m),
                    d2=float(d2), g2=float(g2))
            m.respond(Reply(view=hat, step=t0 + 1))
            if (self.applied % owner.eval_every == 0
                    or self.applied == self.total):
                owner._eval_contribute(self.sid, self.applied,
                                       self.state["theta"],
                                       owner._time_fn(m))

    def _apply(self, work: list):
        if self.owner._gap_ex is not None:
            return self._apply_gap(work)
        k, owner = len(work), self.owner
        if owner.rebalancer is not None:
            # the wire carries full packed gradients; take this shard's
            # current rows (a contiguous view)
            grads = [m.grad[self.r0:self.r1] for m in work]
        else:
            grads = [m.grad for m in work]
        t0 = self._step
        self.state, hats, pres = self.fa.apply_batch(
            self.state, [m.worker_id for m in work], grads,
            [m.t_send for m in work], telemetry=self.telemetry)
        self._step = t0 + k
        if owner.rebalancer is not None and self.state["theta"].is_cuda:
            # the rebalancer steers by busy_s: wait for this shard's
            # update inside run_serve_loop's timed interval, so the gauge
            # measures its row load and not its launches
            torch.cuda.current_stream().synchronize()
        if self.telemetry:
            # partials, on the host before the reply: the group records
            # the row the moment the last shard contributes
            d2 = torch.stack([torch.sum(torch.square(pres[j] - m.view))
                              for j, m in enumerate(work)]).cpu().numpy()
            g2 = torch.stack([torch.sum(torch.square(g))
                              for g in grads]).cpu().numpy()
        evals = []
        for j, m in enumerate(work):
            self.applied += 1
            if self.sid == 0 and self.applied == owner._steady_mark:
                owner.steady_t = time.perf_counter()
            if self.telemetry:
                m.group.add_telemetry(
                    self.sid, worker=m.worker_id, step=t0 + j + 1,
                    lag=t0 + j - m.view_step, t=owner._time_fn(m),
                    d2=float(d2[j]), g2=float(g2[j]))
            m.respond(Reply(view=hats[j], step=t0 + j + 1))
            if (self.applied % owner.eval_every == 0
                    or self.applied == self.total):
                evals.append((owner._time_fn(m), self.applied))
        # eval snapshots take the post-batch state (exact at k=1, i.e.
        # in deterministic mode)
        for t_ev, step_ev in evals:
            owner._eval_contribute(self.sid, step_ev, self.state["theta"],
                                   t_ev)
        # rows move AFTER the eval contribution: an eval and a move at
        # the same watermark both see the ranges before the move
        if owner.rebalancer is not None:
            owner.rebalancer.at_watermark(self)

    def _view_rows_fn(self, r0: int, r1: int):
        fn = self._view_rows_fns.get((r0, r1))
        if fn is None:
            fa = self.fa
            fn = self._view_rows_fns.setdefault(
                (r0, r1), lambda flat, i, a=r0, b=r1:
                fa.view_rows(flat, i, a, b))
        return fn

    def _pull_reply(self, m: GradMsg) -> int:
        if m.rows is not None and not self.owner._stateful_send:
            # hot-row pull over this shard's local rows of the range
            # (possibly none)
            r0, r1 = int(m.rows[0]), int(m.rows[1])
            view = self._view_rows_fn(r0, r1)(self.state, m.worker_id)
            m.respond(Reply(view=view, step=self._step, rows=(r0, r1)))
            return max(r1 - r0, 0)
        view, self.state = self.fa.send_flat(self.state, m.worker_id)
        m.respond(Reply(view=view, step=self._step))
        return int(view.shape[-2])

    def serve(self):
        # unlike Master.serve, no stop flag on normal completion: sibling
        # shards may still be draining (errors stop the cluster inside
        # run_serve_loop)
        run_serve_loop(self)


class ShardedMaster:
    """S row-range shard servers over ONE flat layout.

    The runtime uses it like ``Master`` (``initial_view`` / ``state`` /
    ``master_params`` / ``applied`` / ``step`` / ``serve`` / ``warm`` /
    ``reject_pending``), but workers talk to it through ``frontdoor`` (a
    ``FanoutMailbox``) and the wire is the range-ordered tuple of row
    slices.  Needs a flat-eligible algorithm.
    """

    def __init__(self, algo: Algorithm, state: dict, *, shards: int,
                 history: History, stop: threading.Event, total_grads: int,
                 coalesce: int = 1, record_telemetry: bool = True,
                 eval_fn: Callable | None = None, eval_every: int = 100,
                 injectors: list[FaultInjector] | None = None,
                 time_fn: Callable[[GradMsg], float] | None = None,
                 mailbox_capacity: int = 0,
                 ranges: tuple | None = None,
                 rebalance: bool = False,
                 rebalance_threshold: float = 1.1):
        if shards < 1:
            raise ValueError(f"need shards >= 1, got {shards}")
        if not kernel_eligible(algo):
            raise ValueError(f"sharded master requires a kernel-eligible "
                             f"algorithm, got {algo.name!r}")
        if injectors is not None and len(injectors) != shards:
            raise ValueError("need one injector per shard")
        self.algo = algo
        self._flat_algo = FlatAlgorithm(algo)
        flat = self._flat_algo.adopt(state)
        self.spec = self._flat_algo.spec
        self.device = flat["theta"].device
        if ranges is not None:
            # caller-chosen ranges: contiguous, ordered, non-empty,
            # covering every row
            ranges = tuple((int(a), int(b)) for a, b in ranges)
            if (len(ranges) != shards or ranges[0][0] != 0
                    or ranges[-1][1] != self.spec.rows
                    or any(a >= b for a, b in ranges)
                    or any(ranges[s][1] != ranges[s + 1][0]
                           for s in range(shards - 1))):
                raise ValueError(f"ranges must be {shards} contiguous "
                                 f"non-empty ranges covering "
                                 f"[0, {self.spec.rows}), got {ranges}")
            self.ranges = ranges
        else:
            self.ranges = self.spec.row_ranges(shards)
        self.subs = [self.spec.subspec(r0, r1) for r0, r1 in self.ranges]
        self.rebalancer = None
        if rebalance:
            if self._flat_algo.fam.gap_aware:
                raise ValueError("row rebalancing is not supported for "
                                 "gap-aware members (the cross-shard norm"
                                 " exchange assumes fixed ranges)")
            if record_telemetry:
                raise ValueError("row rebalancing requires "
                                 "record_telemetry=False (telemetry "
                                 "views are sliced to static ranges)")
            self.rebalancer = RowRebalancer(
                self, every=max(1, eval_every),
                threshold=rebalance_threshold)
        self.num_shards = shards
        self.history = history
        self.stop = stop
        self.total = total_grads
        self.coalesce = max(1, coalesce)
        # ga-asgd exchanges two norms a message; its exchange pairs
        # partials by applied count, which needs every shard to apply
        # the same order, so a plan that reorders drains one message at
        # a time (a 1-message chunk cannot be permuted)
        self._gap_ex = None
        if self._flat_algo.fam.gap_aware:
            if injectors is not None and any(
                    inj.plan.reorder_prob > 0 for inj in injectors):
                self.coalesce = 1
            self._gap_ex = _NormExchange(shards, stop)
        self.record_telemetry = record_telemetry
        self.eval_every = max(1, eval_every)
        self._eval_fn = eval_fn
        self._time_fn = time_fn or (lambda m: m.t_send)
        self._inv_sqrt_p = 1.0 / math.sqrt(self.spec.n_elems)
        # the snapshot members record staleness == lag, the others NaN
        # (as the single master does); members whose send writes state
        # serve hot-row pulls with the full send
        fam = self._flat_algo.fam
        self._sent_family = fam.sent_key is not None
        self._stateful_send = fam.stateful_send
        self._hist_lock = threading.Lock()
        self._eval_slots: dict = {}   # step -> {"thetas": {sid: rows}, "t"}
        self._steady_mark = max(1, total_grads // 5)
        self.steady_t: float | None = None
        self.error: BaseException | None = None
        self.state_is_flat = True
        self.mailboxes = [Mailbox(mailbox_capacity) for _ in range(shards)]
        self.shards_ = [
            _ShardServer(s, self, r0, r1, slice_flat(flat, r0, r1),
                         self.mailboxes[s],
                         injectors[s] if injectors is not None else None)
            for s, (r0, r1) in enumerate(self.ranges)]
        del flat
        self.tele_dropped = 0
        self.frontdoor = FanoutMailbox(
            self.mailboxes,
            tele_cb=self._record_telemetry if record_telemetry else None,
            ranges=self.ranges, full_fanout=self.rebalancer is not None,
            drop_cb=self._drop_telemetry if record_telemetry else None)

    # -- worker-visible state -------------------------------------------
    @property
    def applied(self) -> int:
        """Messages applied on EVERY shard (the lagging shard's count)."""
        return min(srv.applied for srv in self.shards_)

    @property
    def step(self) -> int:
        return self.shards_[0]._step

    def _gather_flat(self) -> dict:
        return merge_flat([srv.state for srv in self.shards_])

    @property
    def state(self) -> dict:
        return unpack_state(self.algo, self._gather_flat(), self.spec)

    def master_params(self):
        """The master parameters, assembled from the shards (a copy)."""
        return self.spec.unpack(self.spec.concat_rows(
            [srv.state["theta"] for srv in self.shards_]))

    def initial_view(self, i: int):
        """Initial pull: the range-ordered tuple of the shards' view
        slices (each shard refreshes worker i's snapshot rows, as the
        single master's send does)."""
        views = []
        for srv in self.shards_:
            view, srv.state = self._flat_algo.send_flat(srv.state, i)
            views.append(view)
        return tuple(views), self.step

    def warm(self, hot_ranges: tuple = ()):
        """Load the kernel library and make the hot-row view closures of
        every declared range, sliced to each shard's rows as the fan-out
        slices them.  Launches nothing."""
        for srv, (s0, s1) in zip(self.shards_, self.ranges):
            if self.rebalancer is not None or self._stateful_send:
                continue
            for h0, h1 in hot_ranges:
                srv._view_rows_fn(max(h0, s0) - s0,
                                  max(min(h1, s1), max(h0, s0)) - s0)
        if self.device.type == "cuda":
            FLAT_LIB.load()

    # -- cross-shard aggregation (off the hot path) ----------------------
    def _record_telemetry(self, *, worker, step, lag, t, d2, g2):
        # rows append in message COMPLETION order (barrier-free shard
        # clocks); the step field carries the order, and deterministic
        # mode is serialised and stays in the engine's order
        with self._hist_lock:
            self.history.record(
                time=t, step=step, worker=worker, lag=lag,
                gap=math.sqrt(d2) * self._inv_sqrt_p,
                grad_norm=math.sqrt(g2),
                staleness=float(lag) if self._sent_family
                else float("nan"))

    def _drop_telemetry(self):
        """A fan-out group finished with partials that can never flush:
        counted, not lost silently."""
        with self._hist_lock:
            self.tele_dropped += 1
        mx = self.shards_[0].metrics
        if mx is not None:
            mx.tele_dropped.add(1)

    def _eval_contribute(self, sid: int, step_ev: int, theta_rows, t_ev):
        if self._eval_fn is None:
            return
        # a copy: the shard's theta is updated in place by its next batch
        theta_rows = theta_rows.clone()
        ready = None
        with self._hist_lock:
            slot = self._eval_slots.setdefault(
                step_ev, {"thetas": {}, "t": None})
            slot["thetas"][sid] = theta_rows
            if sid == 0:
                slot["t"] = t_ev
            if len(slot["thetas"]) == self.num_shards:
                ready = self._eval_slots.pop(step_ev)
        if ready is None:
            return
        theta = self.spec.concat_rows(
            [ready["thetas"][s] for s in range(self.num_shards)])
        out = self._eval_fn(self.spec.unpack(theta))
        loss, metric = (out if isinstance(out, tuple)
                        else (out, float("nan")))
        with self._hist_lock:
            self.history.record_eval(time=ready["t"], step=step_ev,
                                     loss=loss, metric=metric)

    # -- lifecycle -------------------------------------------------------
    def serve(self):
        """Run the S shard servers; returns when every shard has applied
        ``total`` gradients (or the cluster stops)."""
        threads = [threading.Thread(target=srv.serve,
                                    name=f"ps-shard-{srv.sid}", daemon=True)
                   for srv in self.shards_]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        errs = [srv.error for srv in self.shards_ if srv.error is not None]
        if errs:
            self.error = errs[0]
        self.stop.set()

    def reject_pending(self):
        """Post-shutdown: unblock any worker still waiting on a reply."""
        for mb in self.mailboxes:
            for m in mb.drain_nowait():
                m.respond(None)

    # -- aggregate stats -------------------------------------------------
    @property
    def busy_s(self) -> float:
        """The busiest shard's busy time (the shards run concurrently)."""
        return max(srv.busy_s for srv in self.shards_)

    @property
    def coalesce_counts(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for srv in self.shards_:
            for k, c in srv.coalesce_counts.items():
                out[k] = out.get(k, 0) + c
        return out

    @property
    def shard_applied(self) -> list[int]:
        return [srv.applied for srv in self.shards_]

    @property
    def shard_busy_s(self) -> list[float]:
        return [srv.busy_s for srv in self.shards_]

    @property
    def current_ranges(self) -> tuple:
        """Live row ranges (sid order == row order, moves included)."""
        return tuple((srv.r0, srv.r1) for srv in self.shards_)

    @property
    def rebalance_moves(self) -> list:
        """(watermark, donor, receiver, rows) of the executed moves."""
        return ([] if self.rebalancer is None
                else list(self.rebalancer.moves))
