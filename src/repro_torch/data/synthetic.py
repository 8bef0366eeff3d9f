"""Deterministic synthetic data pipelines.

``ClassificationTask`` is a Gaussian-mixture classification problem with a
fixed random teacher; it plays the role of CIFAR/ImageNet in the scaling
studies.  Batches are deterministic functions of (worker_id, counter,
seed), drawn from the SAME numpy streams as the JAX package's task, so
both packages see the same batches and the same data order (the paper's
controlled comparison: "all algorithms share the same worker update
schedules").  Tensors land on ``device``; labels are int64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _fold(seed: int, *xs: int) -> np.random.Generator:
    # stable per-(worker, counter) generator (python ints: no overflow)
    mask = (1 << 64) - 1
    h = (int(seed) * 0x9E3779B97F4A7C15) & mask
    for x in xs:
        h ^= (int(x) + 0x9E3779B97F4A7C15 + ((h << 6) & mask) + (h >> 2)) \
            & mask
    return np.random.default_rng(h % (1 << 63))


@dataclasses.dataclass(frozen=True)
class ClassificationTask:
    """Gaussian mixture with a hidden 2-layer teacher defining labels."""
    dim: int = 32
    num_classes: int = 10
    batch_size: int = 64
    seed: int = 0
    device: str = "cuda"

    def _teacher(self):
        rng = np.random.default_rng(self.seed + 1)
        w1 = rng.normal(size=(self.dim, 64)).astype(np.float32) / np.sqrt(
            self.dim)
        w2 = rng.normal(size=(64, self.num_classes)).astype(np.float32) / 8.0
        return w1, w2

    def _tensors(self, x, y):
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(np.asarray(y, np.int64)).to(self.device))

    def batch(self, worker: int, counter: int):
        rng = _fold(self.seed, worker + 1, counter)
        x = rng.normal(size=(self.batch_size, self.dim)).astype(np.float32)
        w1, w2 = self._teacher()
        logits = np.tanh(x @ w1) @ w2
        y = np.argmax(logits + 0.5 * rng.gumbel(size=logits.shape), axis=-1)
        return self._tensors(x, y)

    def eval_batch(self, size: int = 512):
        rng = _fold(self.seed, 0, 0)
        x = rng.normal(size=(size, self.dim)).astype(np.float32)
        w1, w2 = self._teacher()
        y = np.argmax(np.tanh(x @ w1) @ w2, axis=-1)
        return self._tensors(x, y)
