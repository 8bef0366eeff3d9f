"""Attention: only the decode cache's geometry is ported so far.

The attention layers themselves (projections, RoPE, flash and decode
attention, the KV cache) wait for the recurrentgemma and dense slices
(ROADMAP A7).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    capacity: int               # full seq len, or window size for SWA
    window: int | None          # sliding window, None = full attention
    quant: bool = False         # int8 KV cache (per-position/head scales)
