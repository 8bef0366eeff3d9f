"""The port's Mamba-1 selective scan against the JAX package's.

* The plain version (``ref.py``) against the JAX reference
  ``mamba_scan_ref`` and against the Pallas kernel run as the JAX
  package's own tests run it on the CPU (``interpret=True``), at the
  shapes of ``tests/test_kernels.py``, with the JAX package's tolerance
  rtol = atol = 2e-5 (the N-sum of y is taken in another order; the
  largest error measured is about 1e-6).
* A scan split into two calls chained through the last state equals one
  call.
* The inputs as ``apply_mamba`` passes them (bf16 xc, B and C split from
  a bf16 or f32 projection, strided) give bit for bit what contiguous
  float32 copies give, and the JAX reference's result.
* On CPU tensors the wrapper takes the plain version and launches
  nothing; the CUDA-only kernel wrapper refuses CPU tensors (no
  fallback).  The kernel itself is checked against the plain version on
  a card by ``tests/test_torch_gpu.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.kernel import mamba_scan_pallas
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jref

from repro_torch.kernels.mamba_scan import (launches, mamba_scan,
                                            reset_launches)
from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = [(1, 8, 128, 16), (2, 32, 128, 16), (1, 16, 256, 8)]


def _softplus(v):
    return np.logaddexp(v, 0.0).astype(np.float32)


def _inputs(b, s, d, n, seed):
    """Seeded numpy inputs, delta made positive by softplus as
    ``tests/test_kernels.py`` makes it."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (randn(b, s, d), _softplus(randn(b, s, d)) * np.float32(0.1),
            randn(b, s, n), randn(b, s, n),
            -np.abs(randn(d, n)), randn(b, d, n))


def _port(arrs):
    return mamba_scan(*map(torch.from_numpy, arrs))


@pytest.mark.parametrize("b,s,d,n", SHAPES)
def test_plain_version_matches_jax_reference(b, s, d, n):
    arrs = _inputs(b, s, d, n, s + d)
    y, last = _port(arrs)
    ry, rlast = jref(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), **TOL)


@pytest.mark.parametrize("b,s,d,n", SHAPES)
def test_plain_version_matches_pallas_interpret(b, s, d, n):
    arrs = _inputs(b, s, d, n, 7 * s + d)
    y, last = _port(arrs)
    py, plast = mamba_scan_pallas(*map(jnp.asarray, arrs),
                                  seq_chunk=min(8, s), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(plast), **TOL)


@pytest.mark.parametrize("split", [1, 13, 40])
def test_chained_state_handoff_equals_one_call(split):
    """Two calls chained through ``last`` (a prefill continued, or a
    prefill then decode steps) equal one call over the whole sequence,
    and the JAX reference's over the same split."""
    x, dl, bm, cm, a, h0 = map(torch.from_numpy, _inputs(2, 41, 128, 16, 3))
    y, last = mamba_scan(x, dl, bm, cm, a, h0)
    y1, mid = mamba_scan(x[:, :split].contiguous(), dl[:, :split].contiguous(),
                         bm[:, :split].contiguous(),
                         cm[:, :split].contiguous(), a, h0)
    y2, last2 = mamba_scan(x[:, split:].contiguous(),
                           dl[:, split:].contiguous(),
                           bm[:, split:].contiguous(),
                           cm[:, split:].contiguous(), a, mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=0)
    torch.testing.assert_close(last2, last, rtol=0, atol=0)
    jy, jlast = jref(*(jnp.asarray(t.numpy()) for t in
                       (x, dl, bm, cm, a, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(last2.numpy(), np.asarray(jlast), **TOL)


def test_any_length_and_width_on_the_plain_version():
    """S = 1 (a decode step), an odd S and a D that is no multiple of
    the TPU's 128 lanes: the Pallas kernel refuses the last two, the
    port takes them (its CUDA kernel masks the edge)."""
    for b, s, d in ((4, 1, 64), (1, 77, 200)):
        arrs = _inputs(b, s, d, 16, s)
        y, last = _port(arrs)
        ry, rlast = jref(*map(jnp.asarray, arrs))
        assert y.shape == (b, s, d) and last.shape == (b, d, 16)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
        np.testing.assert_allclose(last.numpy(), np.asarray(rlast), **TOL)


@pytest.mark.parametrize("bc_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,d,n", [(2, 9, 128, 16), (1, 1, 64, 16),
                                     (3, 20, 40, 8)])
def test_plain_version_takes_inputs_as_apply_mamba_passes_them(b, s, d, n,
                                                                bc_dtype):
    """bf16 xc and B, C as ``torch.split`` views of a projection (last
    axis contiguous, row stride dt_rank + 2N), the way ``apply_mamba``
    hands them to the scan: bit for bit the plain version on contiguous
    float32 copies (widening is exact), and the JAX reference on those
    float32 inputs at the JAX package's tolerance."""
    x, dl, _, _, a, h0 = _inputs(b, s, d, n, 11 * s + d)
    rng = np.random.default_rng(d)
    dt_rank = 8
    proj = torch.from_numpy(rng.standard_normal(
        (b, s, dt_rank + 2 * n)).astype(np.float32)).to(bc_dtype)
    _, bm, cm = torch.split(proj, [dt_rank, n, n], dim=-1)
    assert bm.stride() == (s * (dt_rank + 2 * n), dt_rank + 2 * n, 1)
    xc = torch.from_numpy(x).bfloat16()
    dl, a, h0 = map(torch.from_numpy, (dl, a, h0))
    y, last = mamba_scan(xc, dl, bm, cm, a, h0)
    assert y.dtype == torch.float32 and y.shape == (b, s, d)
    f32 = (xc.float(), bm.float().contiguous(), cm.float().contiguous())
    ry, rlast = mamba_scan(f32[0], dl, f32[1], f32[2], a, h0)
    torch.testing.assert_close(y, ry, rtol=0, atol=0)
    torch.testing.assert_close(last, rlast, rtol=0, atol=0)
    jy, jlast = jref(*(jnp.asarray(t.numpy()) for t in
                       (f32[0], dl, f32[1], f32[2], a, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)


def test_cpu_wrapper_launches_nothing_and_cuda_wrapper_refuses_cpu():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 4, 128, 16, 0)]
    reset_launches()
    mamba_scan(*arrs)
    assert launches() == {"mamba_scan": 0}
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_cuda(*arrs)
    assert launches() == {"mamba_scan": 0}
