"""Deterministic synthetic data pipelines.

``ClassificationTask`` is a Gaussian-mixture classification problem with a
fixed random teacher; it plays the role of CIFAR/ImageNet in the scaling
studies.  ``LMTask`` is next-token prediction over sequences drawn from a
fixed sparse Markov teacher; it feeds the real-model training paths.
Batches are deterministic functions of (worker_id, counter, seed), drawn
from the SAME numpy streams as the JAX package's tasks, so both packages
see the same batches and the same data order (the paper's controlled
comparison: "all algorithms share the same worker update schedules").
Tensors land on ``device``; labels are int64, tokens int32.
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


@dataclasses.dataclass(frozen=True)
class LMTask:
    """Synthetic language modelling: tokens follow a fixed sparse Markov
    teacher (each token has 4 likely successors, 10 % uniform noise), so
    there is real signal to learn (loss well below uniform)."""
    vocab_size: int = 256
    seq_len: int = 128
    batch_size: int = 8
    seed: int = 0
    device: str = "cuda"

    def _transition(self):
        rng = np.random.default_rng(self.seed + 7)
        return rng.integers(0, self.vocab_size, size=(self.vocab_size, 4))

    def _sample_tokens(self, rng, shape):
        succ = self._transition()
        b, s = shape
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=b)
        for t in range(1, s):
            choice = rng.integers(0, 4, size=b)
            noise = rng.random(size=b) < 0.1
            nxt = succ[toks[:, t - 1], choice]
            rand = rng.integers(0, self.vocab_size, size=b)
            toks[:, t] = np.where(noise, rand, nxt)
        return toks

    def batch(self, worker: int, counter: int):
        rng = _fold(self.seed, worker + 1, counter)
        toks = self._sample_tokens(rng, (self.batch_size, self.seq_len))
        return torch.from_numpy(toks).to(self.device)

    def eval_batch(self, size: int = 16):
        rng = _fold(self.seed, 0, 0)
        return torch.from_numpy(
            self._sample_tokens(rng, (size, self.seq_len))).to(self.device)


def classification_batches(task: ClassificationTask):
    return lambda worker, counter: task.batch(worker, counter)


def lm_batches(task: LMTask):
    return lambda worker, counter: task.batch(worker, counter)
