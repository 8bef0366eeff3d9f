"""Public wrapper of sliding-window flash attention (GQA-aware).

The CUDA kernel for CUDA tensors (or an error): it reads kv head
``h // (H/K)`` itself, so K/V are not repeated.  The plain version for
CPU tensors, after repeating each kv head over its group as the JAX
package's ``ops.swa_attention`` does.  On the card a call that needs a
gradient goes through ``_autograd.KernelFunction``: the kernel forward,
the gradient of ``swa_attention_gqa`` backward (K/V repeated there, so
their gradients sum back over each group to (B,S,K,hd)).
"""
from __future__ import annotations

from .. import _autograd
from .kernel import swa_attention_cuda
from .ref import swa_attention_ref


def swa_attention_gqa(q, k, v, window: int):
    """The plain version over K < H kv heads: each kv head repeated over
    its group of H/K query heads."""
    h, kh = q.shape[2], k.shape[2]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    return swa_attention_ref(q, k, v, window)


def swa_attention(q, k, v, window: int):
    """q: (B,S,H,hd); k, v: (B,S,K,hd) with K | H.  Causal, keys in
    (pos - window, pos].  Returns (B,S,H,hd) in q's type."""
    if q.device.type == "cuda":
        return _autograd.apply(swa_attention_cuda, swa_attention_gqa,
                               (q, k, v), (int(window),))
    if q.device.type == "cpu":
        return swa_attention_gqa(q, k, v, window)
    raise ValueError(f"no swa_attention for device {q.device}")
