"""Sequence packing for LM training: concatenate variable-length
documents into fixed-length training rows with cross-document masking.

Real pretraining data is documents, not fixed windows.  The packer
greedily fills rows of ``seq_len`` tokens, tracks per-token segment ids,
and the loss mask suppresses the next-token target that would cross a
document boundary.  ``positions`` restart at 0 per document so RoPE does
not leak positional signal across documents, and the segment ids confine
attention to each document (``models.attention.flash_attention``).

A copy of the JAX package's ``data/packing.py`` in numpy: the same
first-fit packer and the same document streams (``_fold(seed, worker +
101, counter)``), so both packages pack the same batches element by
element.  ``PackedBatch.tensors`` hands one to the model as its batch
dict.  batch(worker, counter) is a pure function of (seed, worker,
counter): every algorithm sees identical data order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .synthetic import _fold


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    tokens: np.ndarray        # (B, S) int32
    segments: np.ndarray      # (B, S) int32, 0 = padding
    positions: np.ndarray     # (B, S) int32, restart per document
    loss_mask: np.ndarray     # (B, S) float32: 0 where target crosses docs

    def tensors(self, device="cuda") -> dict:
        """The model's batch dict: ``tokens``, ``segments`` and
        ``positions`` int32, ``loss_mask`` float32, on ``device``."""
        return {name: torch.as_tensor(getattr(self, name), device=device)
                for name in ("tokens", "segments", "positions",
                             "loss_mask")}


def pack_documents(docs, seq_len: int, batch_size: int,
                   pad_id: int = 0) -> PackedBatch:
    """Greedy first-fit packing of an iterable of int arrays."""
    rows = np.full((batch_size, seq_len), pad_id, np.int32)
    segs = np.zeros((batch_size, seq_len), np.int32)
    pos = np.zeros((batch_size, seq_len), np.int32)
    fill = np.zeros(batch_size, np.int32)
    seg_count = np.zeros(batch_size, np.int32)

    for doc in docs:
        doc = np.asarray(doc, np.int32)[:seq_len]
        # first row with room (first-fit keeps the packer O(B) per doc)
        target = next((r for r in range(batch_size)
                       if fill[r] + len(doc) <= seq_len), None)
        if target is None:
            break                                 # batch is full
        r, f, n = target, int(fill[target]), len(doc)
        rows[r, f:f + n] = doc
        seg_count[r] += 1
        segs[r, f:f + n] = seg_count[r]
        pos[r, f:f + n] = np.arange(n)
        fill[r] += n

    # loss mask: predict token t+1 only when it belongs to the same doc
    same = (segs[:, 1:] == segs[:, :-1]) & (segs[:, 1:] > 0)
    loss_mask = np.concatenate(
        [same, np.zeros((batch_size, 1), bool)], axis=1).astype(np.float32)
    return PackedBatch(rows, segs, pos, loss_mask)


@dataclasses.dataclass(frozen=True)
class PackedLMTask:
    """Deterministic synthetic document stream -> packed batches."""
    vocab_size: int = 256
    seq_len: int = 128
    batch_size: int = 4
    mean_doc_len: int = 48
    seed: int = 0

    def _docs(self, rng, budget_tokens: int):
        total = 0
        while total < budget_tokens:
            n = int(np.clip(rng.geometric(1.0 / self.mean_doc_len),
                            4, self.seq_len))
            yield rng.integers(1, self.vocab_size, size=n)
            total += n

    def batch(self, worker: int, counter: int) -> PackedBatch:
        rng = _fold(self.seed, worker + 101, counter)
        budget = int(self.batch_size * self.seq_len * 1.2)
        return pack_documents(self._docs(rng, budget), self.seq_len,
                              self.batch_size)
