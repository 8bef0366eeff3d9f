"""Gamma-distributed execution-time model (Ali et al. 2000), paper App. A.4.

Two variants, matching the paper's Algorithms 11/12:

* homogeneous:  one task-level gamma draw q sets the machine scale; every
  iteration of every machine then draws G(alpha_mach, q/alpha_mach).  All
  machines share a mean, stragglers are per-iteration.
* heterogeneous: each machine j draws a persistent mean p[j] from
  G(alpha_mach, mu_mach/alpha_mach); its iterations draw
  G(alpha_task, p[j]/alpha_task).  Machines differ persistently.

Paper constants: mu_task = mu_mach = B * V_mach^2 ... with V chosen so the
mean execution time equals B simulated time units; V_task = 0.1 always,
V_mach = 0.1 (homogeneous) or 0.6 (heterogeneous).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GammaModel:
    batch_size: int = 128
    v_task: float = 0.1
    v_mach: float = 0.1
    heterogeneous: bool = False
    seed: int = 0

    @classmethod
    def homogeneous(cls, batch_size: int = 128, seed: int = 0):
        return cls(batch_size=batch_size, v_task=0.1, v_mach=0.1,
                   heterogeneous=False, seed=seed)

    @classmethod
    def heterogeneous_env(cls, batch_size: int = 128, seed: int = 0):
        return cls(batch_size=batch_size, v_task=0.1, v_mach=0.6,
                   heterogeneous=True, seed=seed)

    def sampler(self, num_workers: int):
        """Returns draw(worker_id) -> execution time for the next batch."""
        rng = np.random.default_rng(self.seed)
        mean = float(self.batch_size)
        a_task = 1.0 / self.v_task ** 2
        a_mach = 1.0 / self.v_mach ** 2
        if self.heterogeneous:
            # Alg. 12: persistent per-machine means p[j].
            p = rng.gamma(a_mach, mean / a_mach, size=num_workers)

            def draw(i: int) -> float:
                return float(rng.gamma(a_task, p[i] / a_task))
        else:
            # Alg. 11: one task-level draw q, shared by all machines.
            q = float(rng.gamma(a_task, mean / a_task))

            def draw(i: int) -> float:
                return float(rng.gamma(a_mach, q / a_mach))
        return draw

    def straggler_probability(self, threshold: float = 1.25,
                              samples: int = 200_000) -> float:
        """P[iteration > threshold * mean] — reproduces paper Fig. 3's red
        tail areas (~1% homogeneous, ~27.9% heterogeneous)."""
        draw = self.sampler(num_workers=max(64, 1))
        times = np.array([draw(i % 64) for i in range(samples)])
        return float(np.mean(times > threshold * self.batch_size))
