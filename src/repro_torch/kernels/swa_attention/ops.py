"""Public wrapper of flash attention (GQA-aware): causal with a sliding
window, non-causal over keys of another length, segment masks.

The CUDA kernel for CUDA tensors (or an error): it reads kv head
``h // (H/K)`` itself, so K/V are not repeated.  The plain version for
CPU tensors, after repeating each kv head over its group as the JAX
package's ``ops.swa_attention`` does.  On the card a call that needs a
gradient goes through ``_autograd.KernelFunction``: the kernel forward,
the gradient of ``swa_attention_gqa`` backward (K/V repeated there, so
their gradients sum back over each group to (B,T,K,hd)); the window,
the causal flag and the segments ride along as static arguments and
take no gradient.
"""
from __future__ import annotations

from .. import _autograd
from .kernel import swa_attention_cuda
from .ref import swa_attention_ref


def swa_attention_gqa(q, k, v, window=None, causal=True, segments=None):
    """The plain version over K < H kv heads: each kv head repeated over
    its group of H/K query heads."""
    h, kh = q.shape[2], k.shape[2]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    return swa_attention_ref(q, k, v, window, causal, segments)


def swa_attention(q, k, v, window=None, *, causal=True, segments=None):
    """q: (B,S,H,hd); k, v: (B,T,K,hd) with K | H.  Causal (T == S): keys
    in (pos - window, pos], every key up to pos with ``window`` None.
    Non-causal (no window): all T keys.  ``segments`` (B,S) int32 confine
    each query to the keys of its own segment > 0 (``swa_attention_ref``
    says what a segment-0 row gets).  Returns (B,S,H,hd) in q's type."""
    window = None if window is None else int(window)
    if q.device.type == "cuda":
        return _autograd.apply(swa_attention_cuda, swa_attention_gqa,
                               (q, k, v), (window, bool(causal), segments))
    if q.device.type == "cpu":
        return swa_attention_gqa(q, k, v, window, causal, segments)
    raise ValueError(f"no swa_attention for device {q.device}")
