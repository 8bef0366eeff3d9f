"""The port's sliding-window attention against the JAX package's.

* The plain version (``ref.py``) against the JAX reference
  ``swa_attention_ref`` and the Pallas kernel run in interpret mode, at
  the shapes of ``tests/test_kernels.py`` (windows below S), float32 and
  bfloat16, with the JAX package's tolerances: 2e-5 at float32 (sums in
  other orders), 3e-2 at bfloat16 (the output rounds to bfloat16 on
  both sides from float32 values that differ in the last float32 bits).
* The GQA wrapper ``ops.swa_attention`` against the JAX model's chunked
  ``flash_attention`` on K < H inputs, with a window below S and one at
  least S (plain causal): 2e-4 at float32, the tolerance of
  ``tests/test_kernels.py::test_swa_matches_model_flash_attention``;
  at bfloat16 0.05 (the JAX flash path rounds q*scale and each
  probability tile to bfloat16 before its products).
* A sequence that is no multiple of any block (the CUDA kernel masks its
  last tile; the plain version takes any S).
* The port's ``flash_attention`` is that function for causal windowed
  attention, and with no window that function at a window of S (the
  dense ``attn`` kind); it raises, naming its ROADMAP item, for the
  cases the port does not run yet.
* CPU tensors take the plain version and launch nothing; the CUDA-only
  wrapper refuses them.  The kernel itself is held against the plain
  version on a card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention.kernel import swa_attention_pallas
from repro.kernels.swa_attention.ref import swa_attention_ref as jref
from repro.models.attention import flash_attention as jflash

from repro_torch.kernels.swa_attention import (launches, reset_launches,
                                               swa_attention,
                                               swa_attention_ref)
from repro_torch.kernels.swa_attention.kernel import swa_attention_cuda
from repro_torch.models.attention import flash_attention

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
FLASH_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd))]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("s,window,qb,kb", [(256, 64, 128, 128),
                                            (256, 128, 64, 64),
                                            (512, 256, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_reference_and_pallas(s, window, qb, kb,
                                                        dtype):
    arrs = _inputs(1, s, 2, 2, 64, s + window)
    out = swa_attention_ref(*_torch(arrs, dtype), window)
    assert out.dtype == TORCH_DT[dtype]
    jarrs = _jax(arrs, dtype)
    ref = jref(*jarrs, window)
    pal = swa_attention_pallas(*jarrs, window=window, q_block=qb,
                               kv_block=kb, interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(pal), **TOL[dtype])


@pytest.mark.parametrize("window", [32, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_wrapper_matches_jax_model_flash_attention(window, dtype):
    arrs = _inputs(2, 128, 4, 2, 32, window)
    out = swa_attention(*_torch(arrs, dtype), window)
    ref = jflash(*_jax(arrs, dtype), causal=True, window=window,
                 q_chunk=32, kv_chunk=32)
    assert out.shape == (2, 128, 4, 32) and out.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), **FLASH_TOL[dtype])
    # the model's flash_attention is the same function in the port
    torch.testing.assert_close(
        flash_attention(*_torch(arrs, dtype), causal=True, window=window),
        out, rtol=0, atol=0)


def test_odd_sequence_and_single_key_window():
    arrs = _inputs(1, 77, 3, 1, 16, 5)
    for window in (1, 10, 500):
        out = swa_attention(*_torch(arrs, "float32"), window)
        jq, jk, jv = _jax(arrs, "float32")
        ref = jref(jq, jnp.repeat(jk, 3, axis=2), jnp.repeat(jv, 3, axis=2),
                   window)
        np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])
    # window 1: each query sees only its own key, so the output is v
    out = swa_attention(*_torch(arrs, "float32"), 1)
    np.testing.assert_allclose(_np(out), np.repeat(arrs[2], 3, axis=2),
                               rtol=1e-6, atol=1e-6)


def test_flash_attention_raises_for_unported_cases():
    q, k, v = _torch(_inputs(1, 8, 2, 2, 8, 0), "float32")
    # full causal attention (the dense kind) is ported: a window of S
    assert torch.equal(flash_attention(q, k, v, causal=True, window=None),
                       swa_attention(q, k, v, 8))
    cases = [(dict(causal=False, window=4), "A7\\(d\\)"),
             (dict(causal=True, window=4, segments=torch.ones(1, 8)),
              "A7\\(e\\)")]
    for kw, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            flash_attention(q, k, v, **kw)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _torch(_inputs(1, 16, 4, 2, 8, 1), "float32")
    reset_launches()
    out = swa_attention(q, k, v, 4)
    assert launches() == {"swa_attention": 0}
    ref = swa_attention_ref(q, k.repeat_interleave(2, 2),
                            v.repeat_interleave(2, 2), 4)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="CUDA"):
        swa_attention_cuda(q, k, v, 4)
