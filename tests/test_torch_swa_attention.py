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
  dense ``attn`` kind).
* The masks of the enc-dec family and of packed sequences, against the
  JAX model's ``flash_attention`` at float32 within rtol 1e-5 / atol
  1e-6 (sums in other orders), on shapes its chunking takes: non-causal
  self-attention (the encoder), non-causal attention over T != S keys
  (cross attention, T above and below S), and causal attention with the
  segments of a ``PackedLMTask`` batch, padding rows included, whose
  output is the mean of V over every key (the JAX recurrence's value);
  the same with windows and GQA, and at bfloat16 within 0.05.  Past the
  JAX windowed path's band of kv chunks, its padding rows average the
  band alone, and only they differ from the port's (ROADMAP C33).  What no
  block asks for is refused: causal attention with T != S, a window on
  non-causal attention, segments of another shape or with T > S.
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
from repro_torch.data.packing import PackedLMTask
from repro_torch.kernels.swa_attention.kernel import swa_attention_cuda
from repro_torch.models.attention import cross_attention, flash_attention

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
    """Every case a block asks for runs (the dense kind at a window of S,
    non-causal, cross-length, segments); the cases none asks for are
    refused on the CPU as on the card."""
    q, k, v = _torch(_inputs(1, 8, 2, 2, 8, 0), "float32")
    # full causal attention (the dense kind): a window of S
    assert torch.equal(flash_attention(q, k, v, causal=True, window=None),
                       swa_attention(q, k, v, 8))
    seg = torch.ones((1, 8), dtype=torch.int32)
    assert flash_attention(q, k, v, causal=False).shape == q.shape
    assert flash_attention(q, k[:, :5], v[:, :5], causal=False).shape == \
        q.shape
    assert flash_attention(q, k, v, window=4, segments=seg).shape == q.shape
    cases = [(dict(causal=False, window=4), (k, v), "window"),
             (dict(causal=True), (k[:, :5], v[:, :5]), "as many keys"),
             (dict(segments=seg[:, :5]), (k, v), "segments"),
             (dict(causal=False, segments=seg), (torch.cat([k, k], 1),
                                                 torch.cat([v, v], 1)),
              "segments"),
             (dict(window=0), (k, v), "at least 1")]
    for kw, (kk, vv), what in cases:
        with pytest.raises(ValueError, match=what):
            flash_attention(q, kk, vv, **kw)


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


# ---------------------------------------------------------------------------
# the enc-dec and packed-sequence masks against the JAX flash_attention
# ---------------------------------------------------------------------------
MASK_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
            "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _segments(b, s, seed):
    """The segment ids of a ``PackedLMTask`` batch: documents of mean
    length s/4 and padding (0) at the end of some rows."""
    seg = PackedLMTask(seq_len=s, batch_size=b, mean_doc_len=max(s // 4, 4),
                       seed=seed).batch(0, seed).segments
    assert (seg == 0).any() and (seg > 1).any()
    return seg


def _mask_case(b, s, t, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, t, kh, hd), (b, t, kh, hd))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,h,kh", [(64, 64, 4, 4), (48, 80, 4, 2),
                                      (96, 40, 4, 1), (256, 512, 2, 2)])
def test_non_causal_and_cross_length_match_jax_flash_attention(s, t, h, kh,
                                                               dtype):
    """The encoder's non-causal self-attention (T == S) and cross
    attention over T != S keys, GQA included."""
    arrs = _mask_case(2, s, t, h, kh, 32, s + t)
    ref = jflash(*_jax(arrs, dtype), causal=False, window=None)
    out = flash_attention(*_torch(arrs, dtype), causal=False)
    assert out.shape == (2, s, h, 32) and out.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), **MASK_TOL[dtype])
    assert torch.equal(cross_attention(*_torch(arrs, dtype)), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kh,window", [(64, 4, 2, None), (128, 2, 2, 16),
                                           (256, 4, 1, None)])
def test_segments_match_jax_flash_attention_padding_rows_included(
        s, h, kh, window, dtype):
    arrs = _mask_case(3, s, s, h, kh, 32, s + 7)
    seg = _segments(3, s, s)
    ref = jflash(*_jax(arrs, dtype), causal=True, window=window,
                 segments=jnp.asarray(seg))
    out = flash_attention(*_torch(arrs, dtype), window=window,
                          segments=torch.from_numpy(seg))
    np.testing.assert_allclose(_np(out), _np(ref), **MASK_TOL[dtype])
    # a padding row attends nowhere: every score is -1e30, each of the T
    # keys gets p = 1, and the row is the mean of V over them
    pad = seg == 0
    vmean = np.repeat(arrs[2].mean(axis=1, keepdims=True), h // kh, axis=2)
    got = _np(out)[pad]
    np.testing.assert_allclose(got, np.broadcast_to(
        vmean, (3, s, h, 32))[pad], **MASK_TOL[dtype])


def test_windowed_padding_rows_past_the_jax_band():
    """At S past the JAX windowed path's band (window 128: 2 of the 3
    kv chunks of 512 a query chunk), the real rows still match the JAX
    ``flash_attention``; a padding row takes the mean of V over all T
    keys (ROADMAP C33), where the JAX path averages its band's chunks
    alone, so there the two differ."""
    s, h, kh, hd, window = 1536, 2, 1, 16, 128
    arrs = _mask_case(2, s, s, h, kh, hd, 11)
    seg = _segments(2, s, 5)
    ref = _np(jflash(*_jax(arrs, "float32"), causal=True, window=window,
                     segments=jnp.asarray(seg)))
    out = _np(flash_attention(*_torch(arrs, "float32"), window=window,
                              segments=torch.from_numpy(seg)))
    real, pad = seg > 0, seg == 0
    assert pad[:, 1280:].any()            # in the last query chunks
    np.testing.assert_allclose(out[real], ref[real], **MASK_TOL["float32"])
    vmean = np.broadcast_to(np.repeat(arrs[2].mean(axis=1, keepdims=True),
                                      h // kh, axis=2), (2, s, h, hd))
    np.testing.assert_allclose(out[pad], vmean[pad], **MASK_TOL["float32"])
    assert np.abs(ref[pad] - vmean[pad]).max() > 1e-2


def test_segments_confine_each_document():
    """A document's outputs do not depend on the other documents of its
    row: two rows packing the same document after different ones agree
    on it."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    for x in (q, k, v):
        x[1, 10:] = x[0, 10:]             # the same last document
    seg = torch.tensor([[1] * 10 + [2] * 14, [1] * 4 + [2] * 6 + [3] * 14],
                       dtype=torch.int32)
    out = flash_attention(q, k, v, segments=seg)
    torch.testing.assert_close(out[0, 10:], out[1, 10:], rtol=1e-6,
                               atol=1e-6)
    non_causal = swa_attention(q, k, v, causal=False, segments=seg)
    torch.testing.assert_close(non_causal[0, 10:], non_causal[1, 10:],
                               rtol=1e-6, atol=1e-6)


def test_ragged_key_tiles_and_plain_gradients_take_masks():
    """T past every block size, and the plain version's autograd (the
    card's backward) through non-causal and segment masks: finite, and
    no gradient reaches keys of another document."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).requires_grad_(True)
        for shape in ((1, 30, 2, 8), (1, 30, 2, 8), (1, 30, 2, 8)))
    seg = torch.tensor([[1] * 12 + [2] * 15 + [0] * 3], dtype=torch.int32)
    out = swa_attention(q, k, v, segments=seg)
    out[:, :12].sum().backward()
    assert torch.isfinite(k.grad).all() and torch.isfinite(q.grad).all()
    assert float(k.grad[:, 12:].abs().max()) == 0.0
    assert float(v.grad[:, 12:].abs().max()) == 0.0
    kc, vc = (torch.from_numpy(rng.standard_normal((1, 1001, 2, 8)).astype(
        np.float32)) for _ in range(2))
    qc = q.detach()
    jout = jflash(*_jax([qc.numpy(), kc.numpy(), vc.numpy()], "float32"),
                  causal=False, window=None, q_chunk=30, kv_chunk=1001)
    np.testing.assert_allclose(_np(swa_attention(qc, kc, vc, causal=False)),
                               _np(jout), **MASK_TOL["float32"])
