"""Learning-rate schedules with the paper's warm-up + momentum correction.

Paper App. A.5: "(we) divided the initial learning rate by the number of
workers N and ramped it up linearly until it reached its original value
after five epochs. We also used momentum correction (Goyal et al., 2017) in
all algorithms to stabilize training when the learning rate changes."

Schedules are functions of the master update counter ``t``.  The port
keeps ``t`` on the host, so a schedule is evaluated on the host in numpy
float32, operation for operation as the JAX package evaluates it in f32
(Python constants enter each operation as float32, as JAX's weakly typed
scalars do), which makes the two packages' rates bit-identical.  ``t``
may be an int or an integer array (elementwise, bit-equal to scalar
calls).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Step-decay schedule with linear warm-up (Goyal et al., 2017).

    lr(t) = base_lr * warmup(t) * decay^(#milestones passed)
    warm-up ramps linearly from base_lr/num_workers to base_lr over
    ``warmup_steps`` master updates.
    """
    base_lr: float
    num_workers: int = 1
    warmup_steps: int = 0
    decay_factor: float = 0.1
    milestones: Sequence[int] = ()

    def __call__(self, t):
        t = np.asarray(t, _F32)
        lr = _F32(self.base_lr)
        if self.warmup_steps > 0 and self.num_workers > 1:
            start = self.base_lr / self.num_workers
            frac = np.clip(t / _F32(self.warmup_steps), _F32(0.0),
                           _F32(1.0))
            warm = _F32(start) + _F32(self.base_lr - start) * frac
        else:
            warm = lr
        decay = _F32(1.0)
        for m in self.milestones:
            decay = decay * np.where(t >= m, _F32(self.decay_factor),
                                     _F32(1.0))
        out = np.asarray(warm * decay, _F32)
        return out[()] if t.ndim == 0 else np.broadcast_to(out, t.shape)


def constant(lr: float) -> Schedule:
    return Schedule(base_lr=lr)


def momentum_correction(v, lr_new, lr_prev):
    """Goyal et al. (2017) momentum correction: when the learning rate
    changes between updates, rescale the momentum buffer by eta_new/eta_prev
    so that the *effective* update magnitude follows the new rate.

    A host float32 scalar factor that callers apply to the momentum.
    """
    lr_new, lr_prev = _F32(lr_new), _F32(lr_prev)
    if lr_prev > 0:
        return _F32(lr_new / np.maximum(lr_prev, _F32(1e-20)))
    return _F32(1.0)
