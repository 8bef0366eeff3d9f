"""Continuous-batching serving scheduler.

Requests arrive over time with different prompt and output lengths.  The
engine keeps a fixed pool of decode SLOTS; each engine step decodes
every active slot once, retires finished requests and admits queued
ones, prefilling each into a freed slot.  The semantics are the JAX
package's:

  * the decode step always runs the FULL slot batch (inactive slots
    decode their last token and are ignored);
  * prefill runs per admission at a bucketed prompt length (the buckets
    that fit the capacity); the prompt is left-padded with token 0 into
    its bucket, and the pad tokens enter the recurrent state, as in the
    JAX package;
  * a request retires after ``max_new`` tokens or at ``eos``.

The JAX engine ``vmap``s a single-sequence decode over a slot axis in
front of every cache leaf, so every slot has its own step ``t`` and, for
attention, its own ring-buffer ``pos`` (capacity,).  Here the cache's own
batch axis IS the slot axis and one batched ``decode_step`` runs the
``(slots, 1)`` tokens: the step counter becomes one per slot, ``t``
(slots,), and each attention cache's ``pos`` one row per slot, (slots,
capacity) (stacked: (repeats, slots, capacity)); ``decode_attention``
then writes, masks and rotates each row at its own step.  A prefilled
request's cache is written into its slot in place: the leaves that
carry the batch take their one row, ``pos`` (which has no batch axis in
a one-sequence cache) its whole row.  An int8 cache's ``k_scale`` and
``v_scale`` take their slot like every other leaf.

Every decoder-only family serves here.  A MoE config's prefill groups
and capacity follow each bucket's length (``mlp.moe_capacity``); its
decode routes each slot's token alone (a group of one, as the JAX
engine's ``vmap`` over slots does).  An M-RoPE config (qwen2-vl) prefills
with the default (3, 1, bucket) positions and no vision prefix, as the
JAX engine does, and decodes each slot at (3, slots, 1) positions from
its own step.  An enc-dec config (seamless-m4t-large-v2) is refused
with a ValueError: a request is a token prompt with no encoder input,
and the JAX engine, which prefills ``{"tokens"}`` alone, fails on one.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..models.api import Model
from ..models.attention import CacheSpec


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int
    arrived: float = 0.0
    # filled by the engine
    output: list = dataclasses.field(default_factory=list)
    finished: float | None = None
    first_token: float | None = None


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _per_slot(cache, slots: int):
    """Give every attention cache's ``pos`` one row per slot."""
    for c in cache["prologue"]:
        if "pos" in c:
            c["pos"] = c["pos"][None].expand(slots, -1).clone()
    for c in cache["unit"]:
        if "pos" in c:
            c["pos"] = c["pos"][:, None].expand(-1, slots, -1).clone()
    cache["t"] = cache["t"].expand(slots).clone()
    return cache


def _install(full, new, s: int) -> None:
    """Write a one-sequence cache ``new`` into slot ``s`` of ``full``: the
    prologue leaves carry the batch first, the stacked unit leaves after
    the repeat axis.  A leaf with one axis fewer than its slotted
    counterpart (``pos``) is the slot's whole row."""
    for fp, np_ in zip(full["prologue"], new["prologue"]):
        for k in fp:
            one = np_[k]
            fp[k][s] = one[0] if one.dim() == fp[k].dim() else one
    for fu, nu in zip(full["unit"], new["unit"]):
        for k in fu:
            one = nu[k]
            fu[k][:, s] = one[:, 0] if one.dim() == fu[k].dim() else one
    full["t"][s] = new["t"]


class Engine:
    """Continuous-batching engine over ``slots`` concurrent sequences."""

    def __init__(self, model: Model, params, *, slots: int = 4,
                 capacity: int = 256, window: int | None = None,
                 prefill_buckets=(32, 64, 128, 256), eos: int | None = None):
        if model.cfg.is_encdec:
            raise ValueError(f"{model.cfg.name} is an enc-dec config: the "
                             f"Engine's requests carry no encoder input")
        self.model = model
        self.params = params
        self.slots = slots
        self.spec = CacheSpec(capacity=capacity, window=window)
        self.buckets = tuple(b for b in prefill_buckets if b <= capacity)
        self.eos = eos
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self.remaining = np.zeros(slots, np.int32)
        self.done: list[Request] = []

        self.device = params["embed"].device
        self.cache = _per_slot(
            model.init_cache(slots, self.spec, device=self.device), slots)
        self.tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.active_mask = np.zeros(slots, bool)

    # -- public API ---------------------------------------------------------
    def submit(self, req: Request):
        req.arrived = time.time()
        self.queue.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            plen = _bucket(len(req.prompt), self.buckets)
            toks = np.full((1, plen), 0, np.int32)
            toks[0, -len(req.prompt):] = req.prompt  # left-pad into bucket
            logits, cache1 = self.model.prefill(
                self.params, {"tokens": torch.as_tensor(
                    toks, device=self.device)}, self.spec)
            tok0 = int(torch.argmax(logits[0, -1]))
            req.first_token = time.time()
            req.output.append(tok0)
            _install(self.cache, cache1, s)
            self.tokens[s, 0] = tok0
            self.active[s] = req
            self.remaining[s] = req.max_new - 1
            self.active_mask[s] = True

    def step(self):
        """One engine iteration: admit, decode every slot, retire."""
        self._admit()
        if not self.active_mask.any():
            return False
        logits, self.cache = self.model.decode_step(
            self.params, self.tokens, self.cache, self.spec)
        toks = torch.argmax(logits[:, -1], -1).to(torch.int32)
        self.tokens = toks[:, None]
        toks_np = toks.cpu().numpy()
        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                continue
            req.output.append(int(toks_np[s]))
            self.remaining[s] -= 1
            hit_eos = self.eos is not None and int(toks_np[s]) == self.eos
            if self.remaining[s] <= 0 or hit_eos:
                req.finished = time.time()
                self.done.append(req)
                self.active[s] = None
                self.active_mask[s] = False
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or self.active_mask.any()) and steps < max_steps:
            self.step()
            steps += 1
        return self.done

    # -- stats ---------------------------------------------------------------
    def stats(self) -> dict:
        if not self.done:
            return {}
        lat = [r.finished - r.arrived for r in self.done]
        ttft = [r.first_token - r.arrived for r in self.done]
        toks = sum(len(r.output) for r in self.done)
        span = max(r.finished for r in self.done) - min(
            r.arrived for r in self.done)
        return {
            "requests": len(self.done),
            "tokens": toks,
            "throughput_tok_s": toks / max(span, 1e-9),
            "mean_latency_s": float(np.mean(lat)),
            "mean_ttft_s": float(np.mean(ttft)),
        }
