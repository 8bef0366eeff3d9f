"""Lag / gap / normalized-gap telemetry (paper Sec. 3 and App. B.3)."""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class History:
    """Per-master-update telemetry collected by the engine."""
    time: list = dataclasses.field(default_factory=list)
    step: list = dataclasses.field(default_factory=list)
    worker: list = dataclasses.field(default_factory=list)
    lag: list = dataclasses.field(default_factory=list)
    gap: list = dataclasses.field(default_factory=list)
    grad_norm: list = dataclasses.field(default_factory=list)
    # per-update sent-snapshot staleness: how many master updates old the
    # applying worker's ``sent`` snapshot was (the scalar the flat layout
    # carries in its SENT_STEP lane).  NaN for snapshot-free algorithms —
    # the series stays row-aligned with lag/gap either way.
    staleness: list = dataclasses.field(default_factory=list)
    # evaluation curve (sparser)
    eval_time: list = dataclasses.field(default_factory=list)
    eval_step: list = dataclasses.field(default_factory=list)
    eval_loss: list = dataclasses.field(default_factory=list)
    eval_metric: list = dataclasses.field(default_factory=list)
    # master parameters at the end of the run (set by both the discrete-event
    # engine and the cluster runtime; the backend-equivalence tests compare
    # these bit-for-bit)
    final_params: Any = None
    # optional metrics tap (``repro_torch.obs.metrics.history_observer``):
    # because BOTH backends funnel every telemetry row through
    # ``record``, hooking here makes their metrics comparable by
    # construction
    observer: Any = dataclasses.field(default=None, repr=False,
                                      compare=False)

    def record(self, *, time, step, worker, lag, gap, grad_norm,
               staleness=float("nan")):
        self.time.append(float(time))
        self.step.append(int(step))
        self.worker.append(int(worker))
        self.lag.append(int(lag))
        self.gap.append(float(gap))
        self.grad_norm.append(float(grad_norm))
        self.staleness.append(float(staleness))
        if self.observer is not None:
            self.observer(time=time, step=step, worker=worker, lag=lag,
                          gap=gap, grad_norm=grad_norm,
                          staleness=staleness)

    def record_eval(self, *, time, step, loss, metric=float("nan")):
        self.eval_time.append(float(time))
        self.eval_step.append(int(step))
        self.eval_loss.append(float(loss))
        self.eval_metric.append(float(metric))

    # -- summaries -------------------------------------------------------
    @property
    def normalized_gap(self) -> np.ndarray:
        """G*(Delta) = G(Delta)/||g|| (paper App. B.3)."""
        g = np.asarray(self.gap)
        n = np.maximum(np.asarray(self.grad_norm), 1e-12)
        return g / n

    def mean_gap(self, skip_frac: float = 0.1) -> float:
        g = np.asarray(self.gap)
        s = int(len(g) * skip_frac)
        return float(np.mean(g[s:])) if len(g) > s else float("nan")

    def mean_lag(self, skip_frac: float = 0.1) -> float:
        l = np.asarray(self.lag)
        s = int(len(l) * skip_frac)
        return float(np.mean(l[s:])) if len(l) > s else float("nan")

    def final_loss(self, k: int = 5) -> float:
        if not self.eval_loss:
            return float("nan")
        return float(np.mean(self.eval_loss[-k:]))

    def summary(self) -> dict[str, Any]:
        return {
            "updates": len(self.step),
            "sim_time": self.time[-1] if self.time else 0.0,
            "mean_lag": self.mean_lag(),
            "mean_gap": self.mean_gap(),
            "mean_normalized_gap": float(np.mean(
                self.normalized_gap[int(0.1 * len(self.gap)):]))
            if self.gap else float("nan"),
            "final_loss": self.final_loss(),
        }
