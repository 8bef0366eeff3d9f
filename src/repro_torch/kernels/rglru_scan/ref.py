"""Plain PyTorch version of the RG-LRU linear recurrence, the oracle of
the CUDA kernel ``rglru_scan`` (the JAX package's ``rglru_scan_ref``):

    h_t = a_t * h_{t-1} + x_t

A loop over t in the inputs' type, the product and the sum rounded
separately, as the kernel (built with ``-fmad=false``) rounds them.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a, x, h0):
    """a, x: (B,S,D); h0: (B,D).  Returns (h_all (B,S,D), h_last (B,D))."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        hs.append(h)
    h_all = torch.stack(hs, 1) if hs else torch.empty_like(a)
    return h_all, h
