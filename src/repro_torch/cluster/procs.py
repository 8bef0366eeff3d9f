"""Process backend: shard servers and workers as spawned processes.

The thread backend (``runtime.py``) keeps every shard server and every
worker inside one CPython process, so they contend on one interpreter
lock: the free cluster leaves the card idle about 94 % of the run,
single master or row-sharded.  This module runs the SAME protocol across
process boundaries, on one card or on the CPU:

* ``ShmLayout`` / ``ShmMailbox`` / ``ShmFanout`` -- the ``Mailbox`` /
  ``FanoutMailbox`` pair split in two.  The control cells live in one
  ``multiprocessing.shared_memory`` block of int64 / f64 cells: stop,
  shutdown, start gate, the global reservation counter, the pin turn,
  per-shard read index / applied count / busy seconds, and per slot an
  8-cell meta header and its send time.  The payload slots (gradient,
  telemetry view, reply: ``(cap, rows_s, 128)`` f32 per shard ring) are
  torch tensors on the run's device, allocated once by the parent and
  handed to every child through ``torch.multiprocessing`` (CUDA IPC on
  the card, shared CPU storage on the CPU): a message never leaves the
  device.  Slot hand-off is generation stamping (payload first, stamp
  second; bounded spin, then a sleeping wait): ``req_gen`` publishes a
  request, ``rep_gen`` a reply, ``con_gen`` the worker's consumption
  that frees the slot.  A writer synchronizes its stream after its
  payload copies and before its stamp, so a reader that sees the stamp
  reads a finished payload.  One GLOBAL reserve counter (under one
  lock) orders every message on every shard ring: the atomic fan-out.
* ``Mailbox.depth`` carried over: depth is ``reserve_counter -
  ring_read_index``, two lock-free int64 loads, so the parent's
  ``SnapshotPublisher`` samples per-shard depth and ``busy_s``.
* ``run_cluster_procs`` replays the threaded lifecycle: warm-up sends in
  worker order on the parent (``send_view`` on sliced states, written
  into each worker's view buffer), shard children that serve with the
  master's ``run_serve_loop`` and apply each drained batch with one
  ``FlatAlgorithm.apply_batch`` (``flat_update_batch``, or
  ``gap_update`` for ga-asgd) on the ring slots in place, worker
  children on the ``Worker`` loop.  A child's traceback or death is
  named in the parent's ``RuntimeError``; telemetry rows, eval points,
  instruments and the children's kernel launch counts come back after
  the run and merge into the ``History`` and ``stats_out`` keys of a
  threaded run.

No slab crosses a pipe: the shard states, the workers' view buffers, the
ring and the eval snapshots are device tensors the parent allocates and
keeps alive until every child has exited; the children write the final
state and each eval snapshot into them.

Spawn, never fork: each child needs its own CUDA context.  Children
re-import the port, so ``grad_fn`` and ``next_batch`` must pickle
(``models.toy.ClassifierGradFn``, ``models.api.ModelGradFn``).  On the
card the parent builds every kernel library before it spawns; a child
only loads them (``_build.NO_BUILD``), and a load or launch failure
fails the run, naming the child.  Workers wait at a start gate until
every worker is up, so spawn time stays out of the run's wall clock.

Scope (``validate_process_config``, the JAX package's support matrix):
live modes only, kernel-eligible members on the flat path, no dropout,
hot-row pulls, rebalancing or custom shard ranges; gap-aware members
only at shards=1.  ``pin_schedule=True`` adds the round-robin turn gate
of the thread backend, so the two backends run the identical message
schedule: the bit-for-bit equivalence harness.
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import pickle
import sys
import time
import traceback
from collections import deque

import numpy as np
import torch

LANES = 128

# control-block int64 cells
C_STOP, C_SHUTDOWN, C_RSV, C_TURN, C_GO, C_CTL = 0, 1, 2, 3, 4, 5
# per-slot meta int64 cells
M_REQ, M_REP, M_CON, M_WID, M_VSTEP, M_RSTEP, M_ROK, M_N = range(8)
# control-block f64 cells
F_T0, F_STEADY, F_CTL = 0, 1, 2

_SPINS = 400           # CPU-yield spins before the sleeping fallback
_SLEEP = 5e-5
_STOP_GRACE = 2.0      # post-stop reply grace before a waiter gives up
_READY_S = 600.0       # bound on a child's start (imports, context, load)
_STACK_BYTES = 256     # children's per-thread stack reservation (_lean_stack)
_CU_LIMIT_STACK_SIZE = 0x00


class ShmLayout:
    """Picklable descriptor of the shared control block.

    The block holds the control cells, then per shard ``cap`` slots of
    meta (int64[8]) and send time (f64).  The payloads are device
    tensors (``alloc_rings``), not part of the block."""

    def __init__(self, ranges, num_workers: int, cap: int,
                 telemetry: bool):
        self.ranges = tuple((int(a), int(b)) for a, b in ranges)
        self.shards = len(self.ranges)
        self.num_workers = int(num_workers)
        self.cap = int(cap)
        self.telemetry = bool(telemetry)
        S = self.shards
        off = 0
        self.o_ctl_i = off
        self.n_ctl_i = C_CTL + 2 * S          # + per-shard ridx, applied
        off += 8 * self.n_ctl_i
        self.o_ctl_f = off
        self.n_ctl_f = F_CTL + S              # + per-shard busy_s
        off += 8 * self.n_ctl_f
        self.o_ring = []
        for _ in self.ranges:
            o = {"meta": off}
            off += 8 * M_N * cap
            o["tsend"] = off
            off += 8 * cap
            self.o_ring.append(o)
        self.total = off

    def ring_bytes(self) -> int:
        """Device bytes of every shard's payload slots."""
        rows = sum(r1 - r0 for r0, r1 in self.ranges)
        return (3 if self.telemetry else 2) * self.cap * rows * LANES * 4

    # -- numpy views over an attached buffer -----------------------------
    def ctl_i(self, buf):
        return np.ndarray((self.n_ctl_i,), np.int64, buf, self.o_ctl_i)

    def ctl_f(self, buf):
        return np.ndarray((self.n_ctl_f,), np.float64, buf, self.o_ctl_f)

    def ring(self, buf, sid: int, payload: dict) -> dict:
        """Shard ``sid``'s ring: its control cells over ``buf`` and its
        payload tensors (``payload``: grad, rep and, with telemetry,
        view)."""
        o, cap = self.o_ring[sid], self.cap
        out = {"meta": np.ndarray((cap, M_N), np.int64, buf, o["meta"]),
               "tsend": np.ndarray((cap,), np.float64, buf, o["tsend"])}
        out.update(payload)
        return out


def alloc_rings(layout: ShmLayout, device) -> list[dict]:
    """Each shard's payload slots on ``device``: grad, rep and (with
    telemetry) view, each ``(cap, rows_s, 128)`` f32."""
    keys = ("grad", "view", "rep") if layout.telemetry else ("grad", "rep")
    return [{k: torch.empty((layout.cap, r1 - r0, LANES),
                            dtype=torch.float32, device=device)
             for k in keys} for r0, r1 in layout.ranges]


def _sync(device) -> None:
    """Wait for this process's work on ``device``: a payload is finished
    before its stamp is stored (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _pause(spins: int) -> int:
    """One step of a bounded-spin-then-sleep wait; returns spins + 1."""
    if spins < _SPINS:
        time.sleep(0)
    else:
        time.sleep(_SLEEP)
    return spins + 1


class _ShmStop:
    """``threading.Event`` facade over the shared stop cell."""

    __slots__ = ("_ctl",)

    def __init__(self, ctl_i):
        self._ctl = ctl_i

    def is_set(self) -> bool:
        return bool(self._ctl[C_STOP])

    def set(self):
        self._ctl[C_STOP] = 1

    def wait(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.is_set():
                return True
            time.sleep(min(2e-3, timeout))
        return self.is_set()


class _ShmMsg:
    """Server-side view of one ring slot, duck-typing ``GradMsg`` for
    ``run_serve_loop``: ``grad`` / ``view`` are views of the slot's
    payload tensors.  ``stage`` copies a reply view into the slot's
    ``rep`` tensor, ``publish`` stamps ``rep_gen`` (the caller
    synchronizes its stream between the two); ``respond`` does both.
    ``idx`` is the global reservation index: the cross-shard identity the
    parent pairs telemetry partials by."""

    __slots__ = ("idx", "worker_id", "grad", "view", "view_step",
                 "t_send", "rows", "_ring", "_slot", "_gen")

    def __init__(self, idx, ring, slot, gen, telemetry):
        meta = ring["meta"][slot]
        self.idx = idx
        self.worker_id = int(meta[M_WID])
        self.view_step = int(meta[M_VSTEP])
        self.t_send = float(ring["tsend"][slot])
        self.grad = ring["grad"][slot]
        self.view = ring["view"][slot] if telemetry else None
        self.rows = None
        self._ring = ring
        self._slot = slot
        self._gen = gen

    def stage(self, view):
        self._ring["rep"][self._slot].copy_(view)

    def publish(self, step):
        meta = self._ring["meta"][self._slot]
        if step is None:
            meta[M_ROK] = 0
        else:
            meta[M_RSTEP] = int(step)
            meta[M_ROK] = 1
        meta[M_REP] = self._gen        # publish AFTER the payload

    def respond(self, reply):
        if reply is not None:
            self.stage(reply.view)
            _sync(self.grad.device)
        self.publish(None if reply is None else reply.step)

    # run_serve_loop's finally block checks m._event.is_set()
    @property
    def _event(self):
        return self

    def is_set(self) -> bool:
        return int(self._ring["meta"][self._slot][M_REP]) == self._gen


class ShmMailbox:
    """Per-shard server-side ring drain, mirroring ``Mailbox``'s drain /
    drain_nowait / depth surface.  FIFO is the global reservation order:
    the drain takes only the CONTIGUOUS published prefix (a reserved but
    not-yet-published slot, a writer mid-copy, blocks everything behind
    it, which keeps every shard's order the same)."""

    def __init__(self, layout: ShmLayout, buf, sid: int, payload=None):
        self.layout = layout
        self.sid = sid
        self.ctl = layout.ctl_i(buf)
        self.ring = layout.ring(buf, sid, payload or {})
        self._ridx_cell = C_CTL + sid

    @property
    def depth(self) -> int:
        """Reserved-but-undrained count: two lock-free int64 loads (the
        ``Mailbox.depth`` sampler contract)."""
        return max(0, int(self.ctl[C_RSV]) - int(self.ctl[self._ridx_cell]))

    def _published(self, idx: int) -> bool:
        cap = self.layout.cap
        return (int(self.ring["meta"][idx % cap][M_REQ])
                == idx // cap + 1)

    def _take(self, ridx: int, k: int) -> list:
        cap, tele = self.layout.cap, self.layout.telemetry
        out = [_ShmMsg(ridx + j, self.ring, (ridx + j) % cap,
                       (ridx + j) // cap + 1, tele) for j in range(k)]
        self.ctl[self._ridx_cell] = ridx + k
        return out

    def drain(self, max_k: int, stop) -> list:
        ridx = int(self.ctl[self._ridx_cell])
        spins = 0
        while not self._published(ridx):
            if stop.is_set():
                return []
            spins = _pause(spins)
        k = 1
        while k < max_k and self._published(ridx + k):
            k += 1
        return self._take(ridx, k)

    def drain_nowait(self) -> list:
        ridx = int(self.ctl[self._ridx_cell])
        k = 0
        while self._published(ridx + k):
            k += 1
        return self._take(ridx, k) if k else []


class ShmFanout:
    """Worker-side fan-out: one reservation under the shared lock orders
    the message on EVERY shard ring (the atomic-fan-out contract), then
    the slot wait, payload copies and publish run out of the lock.  The
    ``con_gen`` wait doubles as bounded-mailbox back-pressure: a worker
    cannot overwrite a slot whose previous occupant is still unserved or
    unconsumed."""

    def __init__(self, layout: ShmLayout, buf, lock, payloads, device):
        self.layout = layout
        self.lock = lock
        self.device = device
        self.ctl = layout.ctl_i(buf)
        self.rings = [layout.ring(buf, s, payloads[s])
                      for s in range(layout.shards)]

    def _reply_ready(self, token) -> bool:
        """True when every shard has published its reply for ``token``:
        its ``rpc_await`` completes without spinning."""
        slot, gen = token
        return all(int(r["meta"][slot][M_REP]) == gen for r in self.rings)

    def rpc_post(self, wid: int, grads, views, view_step: int,
                 t_send: float, stop: _ShmStop, out, *, pending=None,
                 on_settle=None, rpc_timeout=None):
        """The push half of the RPC: reserve a global index, write the
        payload into every shard ring, synchronize, publish, WITHOUT
        waiting for the replies.  Returns an opaque (slot, gen) token
        for ``rpc_await``, or None on shutdown.  ``grads`` writes the
        gradient into the S range-ordered slot tensors it is given (the
        worker packs its gradient straight into the slots: no full
        packed copy); ``views`` is the range-ordered telemetry view, or
        None without telemetry.

        ``pending`` (the caller's FIFO deque of posted-but-unsettled
        tokens) is REQUIRED for deadlock freedom whenever the caller
        keeps tokens in flight across posts: slots are assigned by a
        global counter, so the reserved slot's previous occupant can be
        one of the caller's OWN pending tokens, which only the caller's
        ``rpc_await`` can consume, or another blocked worker's, closing
        a wait cycle.  While spinning for the slot to free, the post
        therefore settles the caller's pending tokens oldest-first as
        soon as their replies are ready (into ``out``), reporting each
        result through ``on_settle(step or None)``.  ``rpc_timeout``
        (seconds) bounds the spin: a wedged slot raises TimeoutError."""
        lay = self.layout
        cap = lay.cap
        with self.lock:
            idx = int(self.ctl[C_RSV])
            self.ctl[C_RSV] = idx + 1
        slot, gen = idx % cap, idx // cap + 1
        # wait for the slot's previous occupant to be fully consumed
        deadline = (time.monotonic() + rpc_timeout
                    if rpc_timeout is not None else None)
        spins = 0
        for ring in self.rings:
            meta = ring["meta"][slot]
            while int(meta[M_CON]) != gen - 1:
                if stop.is_set():
                    return None        # slot stays unpublished
                if pending and self._reply_ready(pending[0]):
                    step = self.rpc_await(pending.popleft(), wid, stop,
                                          rpc_timeout or 1.0, out)
                    if on_settle is not None:
                        on_settle(step)
                    continue
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"worker {wid}: ring slot {slot} not freed in "
                        f"{rpc_timeout}s (previous occupant never "
                        f"consumed)")
                spins = _pause(spins)
        grads([ring["grad"][slot] for ring in self.rings])
        if lay.telemetry:
            for ring, v in zip(self.rings, views):
                ring["view"][slot].copy_(v)
        _sync(self.device)
        for ring in self.rings:
            meta = ring["meta"][slot]
            meta[M_WID] = wid
            meta[M_VSTEP] = view_step
            ring["tsend"][slot] = t_send
            meta[M_REQ] = gen          # publish AFTER the payload
        return (slot, gen)

    def rpc_await(self, token, wid: int, stop: _ShmStop,
                  rpc_timeout: float, out):
        """The pull half: wait for every shard's reply to a posted token,
        copy the reply slices into ``out`` (the worker's own view
        buffers, range order), synchronize and free the slot.  Returns
        the reply step, or None on shutdown / rejection (``out`` then
        holds what it held); raises TimeoutError like
        ``GradMsg.wait_reply``."""
        slot, gen = token
        deadline = time.monotonic() + rpc_timeout
        stop_seen = None
        for s, ring in enumerate(self.rings):
            meta = ring["meta"][slot]
            spins = 0
            while int(meta[M_REP]) != gen:
                now = time.monotonic()
                if now > deadline:
                    raise TimeoutError(
                        f"worker {wid}: no shard-{s} reply in "
                        f"{rpc_timeout}s")
                if stop.is_set():
                    if stop_seen is None:
                        stop_seen = now
                    elif now - stop_seen > _STOP_GRACE:
                        return None
                spins = _pause(spins)
        ok = all(int(r["meta"][slot][M_ROK]) for r in self.rings)
        if ok:
            for ring, dst in zip(self.rings, out):
                dst.copy_(ring["rep"][slot])
            _sync(self.device)
        step = int(self.rings[0]["meta"][slot][M_RSTEP])
        for ring in self.rings:     # free the slot for reuse
            ring["meta"][slot][M_CON] = gen
        return step if ok else None


def _attach(name: str):
    """Attach the block in a child without the resource tracker adopting
    it (bpo-38119: a tracked attachment would unlink the segment when
    the FIRST child exits, yanking it from under the cluster)."""
    from multiprocessing import resource_tracker, shared_memory
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        shm = shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig
    return shm


def _libcuda(*calls) -> None:
    """Make calls ``(name, args...)`` into ``libcuda``, the CUDA
    library below the runtime; a failing call raises."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    for name, *args in calls:
        rc = getattr(cuda, name)(*args)
        if rc:
            raise RuntimeError(f"{name} failed: CUDA error {rc}")


def _lean_stack() -> None:
    """Shrink the current context's per-thread stack reservation (1 KB a
    thread by default, times every thread the card can hold: about
    270 MB a context on an H100) to ``_STACK_BYTES``; CUDA raises
    it again for any kernel that needs more.  Many children each hold a
    context, so this is memory the ring and the workers get back."""
    import ctypes
    _libcuda(("cuCtxSetLimit", _CU_LIMIT_STACK_SIZE,
             ctypes.c_size_t(_STACK_BYTES)))


def _child_setup(job):
    """A child's torch settings from the job (threads, matmul precision)
    and its device context; on the card the kernel libraries load from
    the parent's build and never build here."""
    torch.set_num_threads(job["threads"])
    torch.set_float32_matmul_precision(job["matmul_precision"])
    torch.backends.cuda.matmul.allow_tf32 = job["allow_tf32"]
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.synchronize(device)     # the context exists, current
        _lean_stack()
        from ..kernels import _build
        _build.NO_BUILD = True
    return device


def _launch_counts() -> dict:
    from ..kernels import launches
    return {k: n for k, n in launches().items() if n}


def _gate_acquire(ctl, wid: int, n: int, stop: _ShmStop) -> bool:
    spins = 0
    while int(ctl[C_TURN]) % n != wid:
        if stop.is_set():
            return False
        spins = _pause(spins)
    return True


# =====================================================================
# server child
# =====================================================================
class _ProcServer:
    """One shard server inside its own process: the ``_ShardServer``
    serve surface (``run_serve_loop`` duck type) with ``applied`` /
    ``busy_s`` mirrored into shared control cells, so the parent's
    publisher and the worker children read them lock-free.  Telemetry
    partials stay on the device in a spool (no host sync a batch) and
    flush at eval points, at the cap and at the end; eval snapshots are
    copies of theta into the parent's eval buffer."""

    def __init__(self, sid, fa, state, mailbox, stop, *, total, coalesce,
                 telemetry, eval_every, has_eval, eval_buf, injector,
                 steady_mark, metrics, ctl_i, ctl_f):
        self.sid = sid
        self.fa = fa
        self.state = state
        self.mailbox = mailbox
        self.stop = stop
        self.total = total
        self.coalesce = max(1, coalesce)
        self.telemetry = telemetry
        self.eval_every = eval_every
        self.eval_boundary = eval_every if has_eval else 0
        self.has_eval = has_eval
        self.eval_buf = eval_buf
        self.injector = injector
        self.error = None
        self._step = 0
        self.coalesce_counts = {}
        self.obs_cat = "shard"
        self.metrics = metrics
        self._steady_mark = steady_mark
        self._ctl_i = ctl_i
        self._ctl_f = ctl_f
        self._applied_cell = C_CTL + mailbox.layout.shards + sid
        self.device = state["theta"].device
        self.tele_rows = []            # (idx, wid, step, lag, t, d2, g2)
        self.eval_rows = []            # (watermark, t, eval_buf index)
        self._tele_spool = []
        self._tele_cap = 64

    # shared-cell mirrors (single writer: this process)
    @property
    def applied(self) -> int:
        return int(self._ctl_i[self._applied_cell])

    @applied.setter
    def applied(self, v: int):
        self._ctl_i[self._applied_cell] = v

    @property
    def busy_s(self) -> float:
        return float(self._ctl_f[F_CTL + self.sid])

    @busy_s.setter
    def busy_s(self, v: float):
        self._ctl_f[F_CTL + self.sid] = v

    @property
    def slab_info(self):
        st = self.state
        n_slabs = 2 if "sent" in st else 1
        return (int(st["v"].shape[0]), 2 * int(st["v"].shape[-2]) * n_slabs)

    def _apply(self, work: list):
        """One drained batch: ``apply_batch`` on the ring slots in place
        (the kernel takes the k gradient slots as they lie, no staging
        copy), the telemetry partials on the device, every reply view and
        eval snapshot copied into its slot, ONE stream sync, then the k
        reply stamps."""
        k = len(work)
        t0 = self._step
        self.state, hats, pres = self.fa.apply_batch(
            self.state, [m.worker_id for m in work],
            [m.grad for m in work], [m.t_send for m in work],
            telemetry=self.telemetry)
        self._step = t0 + k
        if self.telemetry:
            d2 = torch.stack([torch.sum(torch.square(pres[j] - m.view))
                              for j, m in enumerate(work)])
            g2 = torch.stack([torch.sum(torch.square(m.grad))
                              for m in work])
            self._tele_spool.append(
                (t0, [(m.idx, m.worker_id, m.view_step, m.t_send)
                      for m in work], d2, g2))
        for j, m in enumerate(work):
            m.stage(hats[j])
        applied, evals = self.applied, []
        for j, m in enumerate(work):
            a = applied + j + 1
            if self.has_eval and (a % self.eval_every == 0
                                  or a == self.total):
                # post-batch theta (chunks never straddle a watermark)
                self.eval_buf[len(self.eval_rows)].copy_(
                    self.state["theta"])
                self.eval_rows.append((a, m.t_send, len(self.eval_rows)))
                evals.append(a)
        _sync(self.device)
        for j, m in enumerate(work):
            self.applied = applied + j + 1
            if self.sid == 0 and self.applied == self._steady_mark:
                self._ctl_f[F_STEADY] = time.monotonic()
            m.publish(t0 + j + 1)
        if self.telemetry and (evals or len(self._tele_spool)
                               >= self._tele_cap):
            self._flush_telemetry()

    def _flush_telemetry(self):
        """The spooled device partials to ``tele_rows`` floats (the only
        host sync on the telemetry path)."""
        for t0, metas, d2, g2 in self._tele_spool:
            d2 = d2.cpu().numpy()
            g2 = g2.cpu().numpy()
            for j, (idx, wid, vstep, t_send) in enumerate(metas):
                self.tele_rows.append(
                    (idx, wid, t0 + j + 1, t0 + j - vstep, t_send,
                     float(d2[j]), float(g2[j])))
        self._tele_spool.clear()


def _run_child(conn, inbox, layout, name, job, body):
    """A child's frame: set up torch and the device, receive the shared
    tensors from ``inbox`` (after the context exists), run
    ``body(tensors, device, attached, ready)`` and send its "done"
    payload.  The tensors live only inside ``body``; a collection after
    it releases this child's hold on them before "done" goes out, so the
    parent frees them once every child is gone.  ``attached`` collects
    the shared-memory attachment, so a failure raises the stop cell."""
    attached = []
    try:
        t_entry = time.time()
        device = _child_setup(job)
        t_cuda = time.time()
        tensors = inbox.recv()
        inbox.close()
        times = (t_entry, t_cuda, time.time())

        def ready():
            conn.send(("ready", times))

        done = body(tensors, device, attached, ready)
        del tensors
        gc.collect()
        conn.send(("done", done))
        conn.close()
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 - shipped to the parent
        try:
            if attached:
                layout.ctl_i(attached[0].buf)[C_STOP] = 1
            conn.send(("error", {"name": name,
                                 "trace": traceback.format_exc()}))
            conn.close()
        except Exception:  # noqa: BLE001
            pass
        sys.exit(1)
    finally:
        for shm in attached:
            try:
                shm.close()       # numpy views may still pin the buffer
            except BufferError:
                pass


def _memory(device) -> int:
    return (torch.cuda.max_memory_reserved(device)
            if device.type == "cuda" else 0)


def server_main(conn, inbox, shm_name, layout, sid, job):
    """Shard-server child entry point (spawn target; module-level for
    picklability).  ``inbox`` brings this shard's ring payload, its row
    tensors (the parent's, updated in place) and its eval snapshot slots
    (None without an eval)."""

    def body(tensors, device, attached, ready):
        from ..kernels.flat_update import FlatAlgorithm
        from ..obs.metrics import MetricsRegistry, serve_instruments
        from .faults import FaultInjector
        from .master import run_serve_loop

        payload, state_rows, eval_buf = tensors
        fa = FlatAlgorithm(job["algo"])
        fa.spec = job["spec"]
        if device.type == "cuda":
            from ..kernels.flat_update._build import GAP_LIB, LIB
            LIB.load()
            if fa.fam.gap_aware:
                GAP_LIB.load()
        attached.append(_attach(shm_name))
        buf = attached[0].buf
        ctl_i = layout.ctl_i(buf)
        ctl_f = layout.ctl_f(buf)
        stop = _ShmStop(ctl_i)
        mailbox = ShmMailbox(layout, buf, sid, payload)
        state = dict(job["state_host"])
        state.update(state_rows)
        injector = None
        if job["faults"] is not None:
            injector = FaultInjector(job["faults"], 0,
                                     job["mean_iter_time"], shard_id=sid)
        server = _ProcServer(
            sid, fa, state, mailbox, stop, total=job["total"],
            coalesce=job["coalesce"], telemetry=job["telemetry"],
            eval_every=job["eval_every"], has_eval=job["has_eval"],
            eval_buf=eval_buf, injector=injector,
            steady_mark=job["steady_mark"],
            metrics=serve_instruments(MetricsRegistry()), ctl_i=ctl_i,
            ctl_f=ctl_f)
        ready()
        try:
            run_serve_loop(server)
        finally:
            # spooled telemetry outlives a serve-loop error, as in
            # Master.serve
            if server.telemetry:
                try:
                    server._flush_telemetry()
                except BaseException as e:  # noqa: BLE001 - keep 1st error
                    if server.error is None:
                        server.error = e

        def _reject_until_shutdown():
            # reject stragglers until the parent confirms every worker
            # is down (the threaded runtime's reject_pending loop)
            while not ctl_i[C_SHUTDOWN]:
                for m in mailbox.drain_nowait():
                    m.respond(None)
                time.sleep(1e-3)
            for m in mailbox.drain_nowait():
                m.respond(None)

        if server.error is not None:
            stop.set()
            conn.send(("error", {
                "name": f"shard-{sid}",
                "trace": "".join(traceback.format_exception(
                    type(server.error), server.error,
                    server.error.__traceback__))}))
            _reject_until_shutdown()
            conn.close()
            sys.exit(1)
        _reject_until_shutdown()
        # the final rows land in the parent's tensors (already them when
        # the update ran in place); only host values cross the pipe
        for key, dst in state_rows.items():
            if server.state[key] is not dst:
                dst.copy_(server.state[key])
        _sync(device)
        mx = server.metrics
        return {
            "state_host": {k: v for k, v in server.state.items()
                           if k not in state_rows},
            "applied": server.applied,
            "busy_s": server.busy_s,
            "step": server._step,
            "coalesce_counts": server.coalesce_counts,
            "tele_rows": server.tele_rows,
            "eval_rows": server.eval_rows,
            "launches": _launch_counts(),
            "max_memory_reserved": _memory(device),
            "pid": os.getpid(),
            "instruments": {
                "drain_k": mx.drain_k._merged(),
                "pulls": mx.pulls.value,
                "overflow": mx.overflow.value,
                "slab_rows_streamed": mx.slab_rows_streamed.value,
                "slab_rows_total": mx.slab_rows_total.value,
                "pull_rows": mx.pull_rows.value,
            }}

    _run_child(conn, inbox, layout, f"shard-{sid}", job, body)


# =====================================================================
# worker child
# =====================================================================
def worker_main(conn, inbox, shm_name, layout, lock, wid, job):
    """Worker child entry point: the ``Worker`` live loop against the
    shared-memory fan-out (spawn target; module-level for
    picklability).  ``inbox`` brings every shard's ring payload and this
    worker's (R, 128) view buffer, allocated by the parent and holding
    its warm-up send; each reply is copied into it, shard slice by shard
    slice."""

    def body(tensors, device, attached, ready):
        from .faults import FaultInjector

        payloads, view = tensors
        attached.append(_attach(shm_name))
        buf = attached[0].buf
        ctl_i = layout.ctl_i(buf)
        ctl_f = layout.ctl_f(buf)
        stop = _ShmStop(ctl_i)
        fanout = ShmFanout(layout, buf, lock, payloads, device)
        n = layout.num_workers
        S = layout.shards
        grad_fn = job["grad_fn"]
        next_batch = job["next_batch"]
        spec = job["spec"]
        ranges = layout.ranges
        # the range-ordered reply destinations: row slices of the view
        out = tuple(view[r0:r1] for r0, r1 in ranges)
        view_step = 0                      # the warm-up sends' step
        telemetry = job["telemetry"]
        depth = job["pipeline_depth"]
        injector = None
        if job["faults"] is not None:
            injector = FaultInjector(job["faults"], n,
                                     job["mean_iter_time"])
        draw = None
        if job["mode"] == "paced":
            import dataclasses as _dc
            em = _dc.replace(job["exec_model"],
                             seed=job["exec_model"].seed
                             + 1000003 * (wid + 1))
            sampler = em.sampler(n)
            draw = (lambda: sampler(wid))
        if device.type == "cuda":
            # warm-up: one gradient of its first batch (a pure function
            # of (worker, counter)), discarded, so the lazy load of the
            # kernels and the library handles lands before the start
            # gate, not in the run (the shards' kernels are prebuilt)
            grad_fn(spec.unpack(view), next_batch(wid, 0))
            _sync(device)
        ready()
        while not ctl_i[C_GO]:             # every worker up: the start
            if stop.is_set():
                break
            time.sleep(1e-3)
        t0 = float(ctl_f[F_T0])
        scale = job["time_scale"]
        if job["mode"] == "paced":
            now_fn = (lambda: (time.monotonic() - t0) / scale)
        else:
            now_fn = (lambda: time.monotonic() - t0)
        pin = job["pin_schedule"]
        total = job["total"]
        applied_cells = ctl_i[C_CTL + S:C_CTL + 2 * S]
        pending = deque()   # pull-ahead: posted-but-unsettled tokens
        grads_sent = 0
        live = True
        # host seconds by loop part (depth 0: the round trip as post and
        # await; each includes the stream syncs of its copies)
        spans = {"batch": 0.0, "grad": 0.0, "post": 0.0, "await": 0.0}

        def _adopt(step):
            # settle bookkeeping shared by the in-order awaits and the
            # settles rpc_post makes while blocked on a slot
            nonlocal view_step, grads_sent, live
            if step is None:
                live = False        # end-of-run rejection / shutdown
            else:
                view_step = step
                grads_sent += 1

        counter = 0
        while (not stop.is_set()
               and int(applied_cells.min()) < total):
            stall = injector.stall(wid) if injector is not None else 0.0
            dt = stall + (draw() if draw is not None else 0.0)
            if dt > 0.0 and stop.wait(dt * scale):
                break
            if pin and not _gate_acquire(ctl_i, wid, n, stop):
                break
            try:
                t_a = time.perf_counter()
                batch = next_batch(wid, counter)
                counter += 1
                t_b = time.perf_counter()
                tree = grad_fn(spec.unpack(view), batch)

                def grads(slots, tree=tree):
                    spec.pack_into(tree, slots, ranges)

                tele = None
                if telemetry:
                    # pull-ahead settles replies into the view while this
                    # push waits for its slot: send a copy of the view
                    # the gradient was computed on
                    v = view.clone() if depth else view
                    tele = tuple(v[r0:r1] for r0, r1 in ranges)
                t_c = time.perf_counter()
                spans["batch"] += t_b - t_a
                spans["grad"] += t_c - t_b
                if depth == 0:
                    tok = fanout.rpc_post(wid, grads, tele, view_step,
                                          now_fn(), stop, out,
                                          rpc_timeout=job["rpc_timeout"])
                    t_d = time.perf_counter()
                    step = (None if tok is None else fanout.rpc_await(
                        tok, wid, stop, job["rpc_timeout"], out))
                    spans["post"] += t_d - t_c
                    spans["await"] += time.perf_counter() - t_d
                else:
                    # pull-ahead: publish the push and move on; the reply
                    # is collected only once more than `depth` RPCs are
                    # outstanding.  `pending` lets a blocked post settle
                    # ready replies in place: the global slot counter can
                    # park this worker behind its OWN unconsumed token
                    tok = fanout.rpc_post(
                        wid, grads, tele, view_step, now_fn(), stop, out,
                        pending=pending, on_settle=_adopt,
                        rpc_timeout=job["rpc_timeout"])
            finally:
                if pin:
                    ctl_i[C_TURN] += 1
            if depth == 0:
                if step is None:
                    break
                view_step = step
                grads_sent += 1
                continue
            if tok is None:
                break
            pending.append(tok)
            while live and len(pending) > depth:
                _adopt(fanout.rpc_await(pending.popleft(), wid, stop,
                                        job["rpc_timeout"], out))
            if not live:
                break
        # settle stragglers so every applied grad is counted (end-of-run
        # rejections resolve to None)
        while pending:
            if fanout.rpc_await(pending.popleft(), wid, stop,
                                job["rpc_timeout"], out) is not None:
                grads_sent += 1
        return {"grads_sent": grads_sent, "launches": _launch_counts(),
                "seconds": spans, "max_memory_reserved": _memory(device),
                "pid": os.getpid()}

    _run_child(conn, inbox, layout, f"worker-{wid}", job, body)

class RemoteChildError(RuntimeError):
    """A child process failed; carries its formatted traceback."""

    def __init__(self, name: str, trace: str):
        super().__init__(f"{name} failed:\n{trace}")
        self.child = name


# =====================================================================
# parent orchestrator
# =====================================================================
def _check_picklable(grad_fn, next_batch):
    for label, fn in (("grad_fn", grad_fn), ("next_batch", next_batch)):
        try:
            pickle.dumps(fn)
        except Exception as e:  # noqa: BLE001
            raise ValueError(
                f"backend='process' requires a picklable {label} "
                f"(children re-import it under spawn); got {fn!r}: {e}.  "
                f"Use a module-level function or a callable class "
                f"(repro_torch.models.toy.ClassifierGradFn, "
                f"repro_torch.models.api.ModelGradFn) instead of a "
                f"closure.") from e


def validate_process_config(algo, cfg):
    """The process backend's support matrix (README "Backends"): the
    JAX package's, with its messages."""
    from ..kernels.flat_update import family_spec_for, kernel_eligible
    if cfg.mode == "deterministic":
        raise ValueError("backend='process' supports live modes only "
                         "(paced/free); deterministic replay needs the "
                         "threaded backend's virtual clock")
    if cfg.use_kernel is False:
        raise ValueError("backend='process' runs the flat kernel wire "
                         "format; use_kernel must not be False")
    if not kernel_eligible(algo):
        raise ValueError(f"backend='process' requires a kernel-eligible "
                         f"algorithm, got {algo.name!r}")
    fam = family_spec_for(algo)
    if fam.gap_aware and cfg.shards > 1:
        raise ValueError("gap-aware members need the cross-shard norm "
                         "exchange (threads-only); use shards=1 on the "
                         "process backend")
    if cfg.faults is not None and cfg.faults.any_dropout:
        raise ValueError("dropout/rejoin is not supported on the "
                         "process backend (stalls and reorder are)")
    if cfg.hot_rows is not None:
        raise ValueError("hot_rows pulls are not supported on the "
                         "process backend")
    if cfg.rebalance or cfg.shard_ranges is not None:
        raise ValueError("row rebalancing / custom shard_ranges are not "
                         "supported on the process backend")
    if cfg.pipeline_depth > 0:
        cap = cfg.mailbox_capacity or max(4, 2 * cfg.num_workers)
        need = (cfg.pipeline_depth + 1) * cfg.num_workers
        if need > cap:
            raise ValueError(
                f"pipeline_depth={cfg.pipeline_depth} can keep "
                f"{need} RPCs in flight but the shm ring holds only "
                f"{cap} slots; raise mailbox_capacity to at least "
                f"{need}")


def _build_kernels(device):
    """Build every kernel library of the port before any child starts
    (one ``nvcc`` per source, all at once); children only load."""
    if device.type != "cuda":
        return
    from ..kernels import (  # noqa: F401 - registers each Library
        _build, dana_update, flat_update, mamba_scan, rglru_scan,
        swa_attention)
    _build.build_all()


def _poll(conns, procs, names, bank, ready, errors):
    """Drain one round of child messages: "ready" stamps ``ready[i]``
    (the monotonic time it arrived, and the child's own wall times of
    its entry, its device context and its tensors), "done" / "error"
    settle ``bank[i]``.  A child that died without reporting lands in
    the bank as an error entry, so the monitor accounts for it at
    once."""
    for i, (c, p) in enumerate(zip(conns, procs)):

        def take(kind, data):
            if kind == "ready":
                ready.setdefault(i, (time.monotonic(), data))
                return False
            if kind == "done":
                bank[i] = data
            else:
                errors.append((data["name"], data["trace"]))
                bank[i] = {"error": data["name"]}
            conns[i] = None
            return True

        if c is not None:
            try:
                while c.poll(0):
                    if take(*c.recv()):
                        break
            except (EOFError, OSError):
                conns[i] = None
        if i in bank or p.is_alive():
            continue
        if conns[i] is not None:
            # gone with its pipe still open: one grace recv for a message
            # in flight when it exited (poll() is also true at EOF, so
            # only recv tells a straggler from a closed pipe)
            try:
                while conns[i] is not None and conns[i].poll(0.2):
                    if take(*conns[i].recv()):
                        break
            except (EOFError, OSError):
                pass
            conns[i] = None
            if i in bank:
                continue
        errors.append((names[i], f"{names[i]} process died without "
                                 f"reporting an error (exit code "
                                 f"{p.exitcode})"))
        bank[i] = {"error": names[i]}


def _raise_first(errors):
    name, tb = errors[0]
    raise RuntimeError(
        f"cluster run failed in {name} "
        f"({len(errors)} process error(s))") from RemoteChildError(name, tb)


_THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


@contextlib.contextmanager
def _child_threads(threads: int):
    """Around the spawns: the children's BLAS thread pools sized to the
    parent's torch thread count (unless the caller's environment sets
    them), so many children on few cores do not each start a pool a
    core."""
    saved = {k: os.environ.get(k) for k in _THREAD_ENV}
    for k in _THREAD_ENV:
        os.environ.setdefault(k, str(threads))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _share(t):
    """CPU tensors move into shared memory (in place) before they cross
    to a child; CUDA tensors cross through IPC as they are."""
    return t if t.is_cuda else t.share_memory_()


def run_cluster_procs(algo, grad_fn, params0, next_batch, cfg,
                      eval_fn=None, stats_out=None, metrics=None):
    """Process-backend twin of the threaded ``run_cluster`` body: same
    arguments, same ``History`` result, same stats keys, plus
    ``launches`` (the children's kernel launch counts, summed; the
    parent's own counters hold its warm-up sends), ``shard_busy_s``,
    ``spawn_s`` (seconds from the first spawn: shards ready, workers
    ready, and the workers' median interpreter entry, device context
    and tensors received), ``worker_seconds`` (the workers' host seconds
    by loop part), ``ring_bytes``, ``mailbox_capacity`` and
    ``child_memory`` (each child's peak allocator reservation, by
    pid).  ``updates_per_s`` counts from the start gate, spawn
    excluded."""
    from multiprocessing import shared_memory

    import torch.multiprocessing as tmp

    from ..core.metrics import History
    from ..core.types import tree_map
    from ..kernels.flat_update import (FlatAlgorithm, family_spec_for,
                                       slice_flat)
    from ..obs import trace
    from ..obs.metrics import (SnapshotPublisher, history_observer,
                               serve_instruments)

    validate_process_config(algo, cfg)
    _check_picklable(grad_fn, next_batch)
    device = torch.device(cfg.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _build_kernels(device)
    n = cfg.num_workers
    S = cfg.shards
    fam = family_spec_for(algo)
    fa = FlatAlgorithm(algo)
    params = tree_map(lambda l: torch.as_tensor(l).to(device), params0)
    flat = fa.adopt(algo.init(params, n))
    del params
    spec = fa.spec
    ranges = spec.row_ranges(S)
    history = History()
    telemetry = cfg.record_telemetry
    shard_states = [slice_flat(flat, r0, r1) for r0, r1 in ranges]
    del flat

    # warm-up sends in worker order on the sliced states (the sharded
    # master's initial_view nesting, so the sent-slab stamps match),
    # each written into the worker's own view buffer
    views = []
    for i in range(n):
        view = torch.empty((spec.rows, LANES), dtype=torch.float32,
                           device=device)
        for s, (r0, r1) in enumerate(ranges):
            piece, shard_states[s] = fa.send_flat(shard_states[s], i)
            view[r0:r1].copy_(piece)
        views.append(_share(view))
    row_keys = [{k: _share(v) for k, v in st.items()
                 if isinstance(v, torch.Tensor)} for st in shard_states]
    host_parts = [{k: v for k, v in st.items()
                   if not isinstance(v, torch.Tensor)}
                  for st in shard_states]
    del shard_states

    cap = cfg.mailbox_capacity or max(4, 2 * n)
    layout = ShmLayout(ranges, n, cap, telemetry)
    payloads = [{k: _share(t) for k, t in p.items()}
                for p in alloc_rings(layout, device)]
    eval_every = max(1, cfg.eval_every)
    n_evals = 0
    if eval_fn is not None:
        n_evals = (cfg.total_grads // eval_every
                   + (cfg.total_grads % eval_every != 0))
    eval_bufs = [None] * S
    if n_evals:
        eval_bufs = [_share(torch.empty((n_evals, r1 - r0, LANES),
                                        dtype=torch.float32,
                                        device=device))
                     for r0, r1 in ranges]
    if device.type == "cuda":
        # the children allocate from the card, not from this cache
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    ctx = tmp.get_context("spawn")
    shm = shared_memory.SharedMemory(create=True, size=layout.total)
    lock = ctx.Lock()
    ctl_i = layout.ctl_i(shm.buf)
    ctl_f = layout.ctl_f(shm.buf)
    ctl_i[:] = 0
    ctl_f[:] = 0.0
    stop = _ShmStop(ctl_i)
    steady_mark = max(1, cfg.total_grads // 5)
    inv_sqrt_p = 1.0 / math.sqrt(spec.n_elems)
    common = dict(
        spec=spec, faults=cfg.faults, total=cfg.total_grads,
        telemetry=telemetry, mean_iter_time=cfg.exec_model.batch_size,
        device=str(device),
        # never more threads in all than host cores: one child a core
        # at most, the parent's count at most
        threads=max(1, min(torch.get_num_threads(),
                           (os.cpu_count() or 1) // (n + S))),
        matmul_precision=torch.get_float32_matmul_precision(),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    server_job = dict(common, algo=algo, coalesce=cfg.coalesce,
                      eval_every=eval_every, has_eval=eval_fn is not None,
                      steady_mark=steady_mark)
    worker_job = dict(
        common, grad_fn=grad_fn, next_batch=next_batch, mode=cfg.mode,
        exec_model=cfg.exec_model, time_scale=cfg.time_scale,
        rpc_timeout=cfg.rpc_timeout, pin_schedule=cfg.pin_schedule,
        pipeline_depth=cfg.pipeline_depth)

    servers, workers = [], []
    server_conns, worker_conns = [], []
    payloads_done: dict[int, dict] = {}     # sid -> server done payload
    worker_done: dict[int, dict] = {}
    ready_s: dict[int, float] = {}
    ready_w: dict[int, float] = {}
    errors: list[tuple[str, str]] = []      # (name, trace)
    names_s = [f"shard-{s}" for s in range(S)]
    names_w = [f"worker-{w}" for w in range(n)]
    publisher = None
    spawn_s = {}

    def _start(target, args, tensors, name):
        # results come back on one pipe; the shared tensors go out on
        # another once the child runs (they cross by reference: CUDA IPC
        # handles, shared CPU storage), so no Process keeps them
        pr, pw = ctx.Pipe(duplex=False)
        ir, iw = ctx.Pipe(duplex=False)
        p = ctx.Process(target=target, args=(pw, ir) + args, name=name,
                        daemon=True)
        p.start()
        pw.close()
        ir.close()
        iw.send(tensors)
        iw.close()
        return p, pr

    def _poll_all():
        _poll(worker_conns, workers, names_w, worker_done, ready_w,
              errors)
        _poll(server_conns, servers, names_s, payloads_done, ready_s,
              errors)

    def _wait_ready(ready, count, what):
        deadline = time.monotonic() + max(cfg.rpc_timeout, _READY_S)
        while len(ready) < count and not errors:
            _poll_all()
            if time.monotonic() > deadline:
                raise RuntimeError(f"process backend: {what} failed to "
                                   f"start in time")
            time.sleep(0.01)
        if errors:
            _raise_first(errors)

    t_spawn, t_spawn_wall = time.monotonic(), time.time()
    try:
        with _child_threads(common["threads"]):
            for sid in range(S):
                proc, conn = _start(
                    server_main,
                    (shm.name, layout, sid,
                     dict(server_job, state_host=host_parts[sid])),
                    (payloads[sid], row_keys[sid], eval_bufs[sid]),
                    f"ps-proc-shard-{sid}")
                servers.append(proc)
                server_conns.append(conn)
            for wid in range(n):
                proc, conn = _start(
                    worker_main, (shm.name, layout, lock, wid, worker_job),
                    (payloads, views[wid]), f"ps-proc-worker-{wid}")
                workers.append(proc)
                worker_conns.append(conn)
        spawn_s["start_calls"] = time.monotonic() - t_spawn
        _wait_ready(ready_s, S, "shard servers")
        spawn_s["shards_ready"] = max(
            v[0] for v in ready_s.values()) - t_spawn
        _wait_ready(ready_w, n, "workers")
        spawn_s["workers_started"] = max(
            v[0] for v in ready_w.values()) - t_spawn
        # the workers' medians, from the spawn: interpreter and imports
        # done, device context made, shared tensors received
        for j, key in enumerate(("worker_entry", "worker_context",
                                 "worker_tensors")):
            spawn_s[key] = float(np.median(
                [v[1][j] for v in ready_w.values()])) - t_spawn_wall

        if metrics is not None:
            history.observer = history_observer(metrics)
        if metrics is not None or trace.enabled:
            parent_boxes = [ShmMailbox(layout, shm.buf, s)
                            for s in range(S)]
            sources = {}
            for s in range(S):
                sources[f"mailbox_depth/shard{s}"] = \
                    (lambda mb=parent_boxes[s]: mb.depth)
                sources[f"busy_s/shard{s}"] = \
                    (lambda s=s: float(ctl_f[F_CTL + s]))
            publisher = SnapshotPublisher(sources, registry=metrics)
            publisher.start()

        # every child is up: open the start gate
        ctl_f[F_T0] = time.monotonic()
        t0_wall = time.perf_counter()
        ctl_i[C_GO] = 1

        applied_cells = ctl_i[C_CTL + S:C_CTL + 2 * S]
        stop_deadline = None
        while len(worker_done) < n:
            _poll_all()
            if errors:
                stop.set()
            if int(applied_cells.min()) >= cfg.total_grads:
                stop.set()    # release pin-gate / drain waiters
            if stop.is_set() and stop_deadline is None:
                stop_deadline = (time.monotonic()
                                 + max(cfg.rpc_timeout, 10.0))
            if stop_deadline is not None \
                    and time.monotonic() > stop_deadline:
                for name, proc in zip(names_w, workers):
                    if proc.is_alive():
                        proc.terminate()
                        errors.append((name, f"{name} failed to shut "
                                             f"down"))
                break
            if len(worker_done) < n:
                time.sleep(0.005)

        # every worker accounted for (or terminated): let servers finish
        stop.set()
        ctl_i[C_SHUTDOWN] = 1
        t_end = time.perf_counter()
        t_end_mono = time.monotonic()
        steady_mono = float(ctl_f[F_STEADY])
        deadline = time.monotonic() + max(cfg.rpc_timeout, 30.0)
        while len(payloads_done) < S:
            _poll(server_conns, servers, names_s, payloads_done, ready_s,
                  errors)
            if time.monotonic() > deadline:
                break
            if len(payloads_done) < S:
                time.sleep(0.005)
        for proc in workers + servers:
            proc.join(timeout=5.0)
    finally:
        if publisher is not None:
            publisher.stop()
        ctl_i[C_STOP] = 1
        for proc in workers + servers:
            if proc.is_alive():
                proc.terminate()
        for proc in workers + servers:
            proc.join(timeout=5.0)
            if not proc.is_alive():
                proc.close()
        try:
            shm.close()
        except BufferError:
            pass
        try:
            shm.unlink()
        except FileNotFoundError:
            pass

    if errors:
        _raise_first(errors)
    missing = [s for s in range(S) if "applied" not in payloads_done[s]]
    if missing:
        raise RuntimeError(f"process backend: missing shard results "
                           f"for shards {missing}")
    applied = min(payloads_done[s]["applied"] for s in range(S))
    if applied != cfg.total_grads:
        raise RuntimeError(f"cluster stopped early: applied "
                           f"{applied}/{cfg.total_grads} gradients")

    # -- post-hoc merge: state, telemetry, evals, instruments ------------
    history.final_params = spec.unpack(spec.concat_rows(
        [row_keys[s]["theta"] for s in range(S)]))
    host0 = payloads_done[0]["state_host"]
    del row_keys, payloads, views

    tele_dropped = 0
    if telemetry:
        groups: dict[int, list] = {}
        for s in range(S):
            for row in payloads_done[s]["tele_rows"]:
                groups.setdefault(row[0], []).append((s, row))
        # shard 0's apply order is the canonical History row order
        for idx, wid, step, lag, t, _, _ in payloads_done[0]["tele_rows"]:
            parts = groups.get(idx, [])
            if len(parts) != S:
                tele_dropped += 1
                continue
            d2 = sum(r[5] for _, r in parts)
            g2 = sum(r[6] for _, r in parts)
            history.record(
                time=t, step=step, worker=wid, lag=lag,
                gap=math.sqrt(d2) * inv_sqrt_p, grad_norm=math.sqrt(g2),
                staleness=(float(lag) if fam.sent_key is not None
                           else float("nan")))
        # partial groups missing shard 0 entirely
        for idx, parts in groups.items():
            if len(parts) != S and not any(s == 0 for s, _ in parts):
                tele_dropped += 1

    if eval_fn is not None:
        slots: dict[int, dict] = {}
        for s in range(S):
            for step_ev, t_ev, j in payloads_done[s]["eval_rows"]:
                slot = slots.setdefault(step_ev, {"rows": {}, "t": None})
                slot["rows"][s] = j
                if s == 0:
                    slot["t"] = t_ev
        for step_ev in sorted(slots):
            slot = slots[step_ev]
            if len(slot["rows"]) != S:
                continue
            theta = spec.concat_rows(
                [eval_bufs[s][slot["rows"][s]] for s in range(S)])
            out = eval_fn(spec.unpack(theta))
            loss, metric = (out if isinstance(out, tuple)
                            else (out, float("nan")))
            history.record_eval(time=slot["t"], step=step_ev, loss=loss,
                                metric=metric)
    del eval_bufs
    if device.type == "cuda":
        # the children are gone: free what they held of this process's
        # memory
        torch.cuda.ipc_collect()

    if metrics is not None:
        mx = serve_instruments(metrics)
        for s in range(S):
            inst = payloads_done[s]["instruments"]
            counts, total_, cnt, lo, hi = inst["drain_k"]
            if cnt:
                mx.drain_k._cells[f"proc-shard{s}"] = \
                    [list(counts), total_, cnt, lo, hi]
            mx.pulls.add(inst["pulls"])
            mx.overflow.add(inst["overflow"])
            mx.slab_rows_streamed.add(inst["slab_rows_streamed"])
            mx.slab_rows_total.add(inst["slab_rows_total"])
            mx.pull_rows.add(inst["pull_rows"])
        if tele_dropped:
            mx.tele_dropped.add(tele_dropped)

    if stats_out is not None:
        coalesce_counts: dict[int, int] = {}
        launches: dict[str, int] = {}
        for s in range(S):
            for k, c in payloads_done[s]["coalesce_counts"].items():
                coalesce_counts[k] = coalesce_counts.get(k, 0) + c
        for done in list(payloads_done.values()) + list(
                worker_done.values()):
            for k, c in done["launches"].items():
                launches[k] = launches.get(k, 0) + c
        applied_total = sum(k * v for k, v in coalesce_counts.items())
        busy = max(payloads_done[s]["busy_s"] for s in range(S))
        steady = None
        if 0.0 < steady_mono < t_end_mono:
            steady = ((applied - steady_mark)
                      / max(t_end_mono - steady_mono, 1e-9))
        stats_out.update(
            applied=applied,
            wall_s=t_end - t0_wall,
            updates_per_s=applied / max(t_end - t0_wall, 1e-9),
            steady_updates_per_s=steady,
            master_busy_s=busy,
            master_updates_per_s=applied / max(busy, 1e-9),
            coalesce_counts=dict(sorted(coalesce_counts.items())),
            mean_coalesce=(applied_total
                           / max(sum(coalesce_counts.values()), 1)),
            grads_per_worker={w: worker_done[w].get("grads_sent", 0)
                              for w in sorted(worker_done)},
            use_kernel=True,
            flat=True,
            shards=S,
            backend="process",
            shard_applied=[payloads_done[s]["applied"] for s in range(S)],
            shard_busy_s=[payloads_done[s]["busy_s"] for s in range(S)],
            telemetry_dropped=tele_dropped,
            launches=launches,
            worker_seconds={k: sum(d["seconds"][k]
                                   for d in worker_done.values())
                            for k in ("batch", "grad", "post", "await")},
            spawn_s=spawn_s,
            ring_bytes=layout.ring_bytes(),
            mailbox_capacity=cap,
            child_memory={
                "shards": {payloads_done[s]["pid"]: payloads_done[s][
                    "max_memory_reserved"] for s in range(S)},
                "workers": {worker_done[w]["pid"]: worker_done[w][
                    "max_memory_reserved"] for w in sorted(worker_done)}},
        )
        if publisher is not None:
            stats_out["obs_series"] = publisher.series()
        if fa.lane is not None:
            stats_out["sent_staleness"] = [
                float(x) for x in np.asarray(fa.staleness(host0))]
        if fam.rate_weighted:
            from ..core.flat import RATE_INTERVAL, RATE_LANE
            stats_out["rate_intervals"] = [
                float(x) for x in np.asarray(
                    RATE_LANE.get(host0["rate"], RATE_INTERVAL))]
    return history
