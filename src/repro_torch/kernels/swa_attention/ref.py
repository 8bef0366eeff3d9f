"""Plain PyTorch version of flash attention with a causal sliding window,
non-causal attention over keys of another length, and segment masks: the
oracle of the CUDA kernel ``swa_attention`` (a transcription of the JAX
package's ``swa_attention_ref``, widened to the cases of its model's
``flash_attention``: the score matrix materialised in float32, so small
shapes only).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def check_masks(q, k, window, causal, segments):
    """Refuse what no block asks for: causal attention over keys of
    another length than the queries', a window on non-causal attention,
    a window below 1, and segments of another shape than (B, S) or with
    fewer queries than keys (keys take ``segments[:, :T]``)."""
    b, s, t = q.shape[0], q.shape[1], k.shape[1]
    if causal and t != s:
        raise ValueError(f"causal attention takes as many keys as queries, "
                         f"got {t} keys for {s} queries")
    if window is not None and not causal:
        raise ValueError("a window needs causal attention")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if segments is not None and (tuple(segments.shape) != (b, s) or t > s):
        raise ValueError(f"segments must be (B, S) = {(b, s)} with T <= S, "
                         f"got {tuple(segments.shape)} for T = {t}")


def swa_attention_ref(q, k, v, window=None, causal=True, segments=None):
    """q: (B, S, H, hd); k, v: (B, T, H, hd), the same head count (the
    caller expands GQA).  Causal (T == S): keys in (pos - window, pos],
    every key up to pos when ``window`` is None.  Non-causal: every one
    of the T keys.  ``segments`` (B, S) int: query i attends key j only
    where ``segments[:, i] == segments[:, j] > 0`` (keys take
    ``segments[:, :T]``).  A masked score is -1e30, as in the JAX
    recurrence, so a row masked against every key (a segment-0 row)
    takes the mean of V over all T keys (with a window too, where the
    JAX path averages only its band's kv chunks: ROADMAP C33).  float32
    math, the output in q's type."""
    check_masks(q, k, window, causal, segments)
    s, t, hd = q.shape[1], k.shape[1], q.shape[-1]
    # the scalars are made on q's device (no host-to-device copy, which
    # waits for the stream, in every training step's backward)
    scale = 1.0 / torch.sqrt(torch.full((), hd, dtype=torch.float32,
                                        device=q.device))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        pos = torch.arange(s, device=q.device)
        qpos, kpos = pos[:, None], pos[None, :t]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (qpos - kpos < window)
    if segments is not None:
        sq, sk = segments[:, :, None], segments[:, None, :t]
        seg = ((sq == sk) & (sq > 0))[:, None]               # (B,1,S,T)
        mask = seg if mask is None else mask & seg
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
