"""Plain PyTorch version of causal sliding-window attention, the oracle
of the CUDA kernel ``swa_attention`` (a transcription of the JAX
package's ``swa_attention_ref``: the score matrix materialised in
float32, so small shapes only).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def swa_attention_ref(q, k, v, window):
    """q, k, v: (B, S, H, hd), the same head count (the caller expands
    GQA).  Causal, keys restricted to (pos - window, pos]; float32 math,
    the output in q's type."""
    s, hd = q.shape[1], q.shape[-1]
    # the scalars are made on q's device (no host-to-device copy, which
    # waits for the stream, in every training step's backward)
    scale = 1.0 / torch.sqrt(torch.full((), hd, dtype=torch.float32,
                                        device=q.device))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = (kpos <= qpos) & (qpos - kpos < window)
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
