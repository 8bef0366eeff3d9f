"""Fault injection for the cluster runtime.

The paper's heterogeneous environment (App. A.4) models *statistical*
variation; a live cluster additionally sees discrete faults.  Three kinds,
all driven by seeded numpy generators so every fault schedule is
reproducible, and equal to the JAX package's for the same plan:

* **transient stalls** — with probability ``stall_prob`` a worker's
  iteration takes ``stall_scale`` extra mean-iteration times (GC pause,
  network hiccup).  Available in every mode; in deterministic mode the
  stall inflates *virtual* time, so the event order (and hence the run)
  stays reproducible.
* **dropout / rejoin** — ``dropout`` lists ``(worker_id, out_step,
  rejoin_step)`` windows in master-update steps.  While the master's step
  counter is inside the window the worker is offline; on rejoin it
  discards its stale view and pull-requests fresh parameters.  This is the
  scenario DANA's per-worker momentum must tolerate (a returning worker's
  momentum is stale, not wrong).  Not supported in deterministic mode.
* **message reordering** — with probability ``reorder_prob`` the master
  applies a drained batch in a permuted order (out-of-order delivery).
  Only observable when the coalescing window is > 1; permutation within
  the drained batch keeps the protocol deadlock-free.

Under the row-sharded master each shard server gets its OWN injector
(``shard_id`` seeds an independent reorder substream), so out-of-order
delivery on one shard's link is independent of the others;
``reorder_shards`` confines reordering to the listed shard ids.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..obs import trace


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    seed: int = 0
    stall_prob: float = 0.0
    stall_scale: float = 5.0
    dropout: tuple = ()            # ((worker_id, out_step, rejoin_step), ...)
    reorder_prob: float = 0.0
    reorder_shards: tuple | None = None   # shard ids to reorder; None = all

    @property
    def any_dropout(self) -> bool:
        return bool(self.dropout)


class FaultInjector:
    """Stateful, seeded executor of a FaultPlan.

    Stall draws use one per-worker substream each so that thread scheduling
    cannot change which iteration stalls; reorder draws live on the
    master's own substream (a shard's, seeded with its ``shard_id``).  A
    shard's injector only reorders: build it with ``num_workers=0``.
    """

    def __init__(self, plan: FaultPlan, num_workers: int,
                 mean_iter_time: float, shard_id: int | None = None):
        self.plan = plan
        self.mean_iter_time = mean_iter_time
        self.shard_id = shard_id
        self._stall_rngs = [
            np.random.default_rng((plan.seed, 7919, wid))
            for wid in range(num_workers)
        ]
        self._reorder_rng = np.random.default_rng(
            (plan.seed, 104729) if shard_id is None
            else (plan.seed, 104729, shard_id))
        self._windows: dict[int, list[tuple[int, int]]] = {}
        for wid, out, back in plan.dropout:
            if back <= out:
                raise ValueError(f"dropout window {out}..{back} is empty")
            self._windows.setdefault(int(wid), []).append((int(out),
                                                           int(back)))

    # -- worker side -----------------------------------------------------
    def stall(self, worker_id: int) -> float:
        """Extra execution time (same units as the gamma model) injected
        into this iteration; 0.0 almost always."""
        p = self.plan.stall_prob
        if p <= 0.0:
            return 0.0
        rng = self._stall_rngs[worker_id]
        if rng.random() >= p:
            return 0.0
        return float(self.plan.stall_scale * self.mean_iter_time
                     * (0.5 + rng.random()))

    def offline_until(self, worker_id: int, master_step: int) -> int | None:
        """If the worker is inside a dropout window at ``master_step``,
        the step at which it rejoins; else None."""
        for out, back in self._windows.get(worker_id, ()):
            if out <= master_step < back:
                return back
        return None

    # -- master side -----------------------------------------------------
    def reorder(self, msgs: list) -> list:
        if self.plan.reorder_prob <= 0.0 or len(msgs) < 2:
            return msgs
        if (self.plan.reorder_shards is not None
                and self.shard_id is not None
                and self.shard_id not in self.plan.reorder_shards):
            return msgs
        if self._reorder_rng.random() >= self.plan.reorder_prob:
            return msgs
        perm = self._reorder_rng.permutation(len(msgs))
        if trace.enabled:
            trace.instant("reorder", "faults", k=len(msgs),
                          shard=-1 if self.shard_id is None
                          else self.shard_id)
        return [msgs[j] for j in perm]
