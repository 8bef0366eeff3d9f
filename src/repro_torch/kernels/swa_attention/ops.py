"""Public wrapper of sliding-window flash attention (GQA-aware).

The CUDA kernel for CUDA tensors (or an error): it reads kv head
``h // (H/K)`` itself, so K/V are not repeated.  The plain version for
CPU tensors, after repeating each kv head over its group as the JAX
package's ``ops.swa_attention`` does.
"""
from __future__ import annotations

from .kernel import swa_attention_cuda
from .ref import swa_attention_ref


def swa_attention(q, k, v, window: int):
    """q: (B,S,H,hd); k, v: (B,S,K,hd) with K | H.  Causal, keys in
    (pos - window, pos].  Returns (B,S,H,hd) in q's type."""
    if q.device.type == "cuda":
        return swa_attention_cuda(q, k, v, window)
    if q.device.type == "cpu":
        h, kh = q.shape[2], k.shape[2]
        if kh != h:
            k = k.repeat_interleave(h // kh, dim=2)
            v = v.repeat_interleave(h // kh, dim=2)
        return swa_attention_ref(q, k, v, window)
    raise ValueError(f"no swa_attention for device {q.device}")
