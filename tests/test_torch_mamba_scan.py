"""The port's Mamba-1 selective scan against the JAX package's.

* The plain version (``ref.py``) against the JAX reference
  ``mamba_scan_ref`` and against the Pallas kernel run as the JAX
  package's own tests run it on the CPU (``interpret=True``), at the
  shapes of ``tests/test_kernels.py``, with the JAX package's tolerance
  rtol = atol = 2e-5 (the N-sum of y is taken in another order; the
  largest error measured is about 1e-6).
* A scan split into two calls chained through the last state equals one
  call.
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


def test_cpu_wrapper_launches_nothing_and_cuda_wrapper_refuses_cpu():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 4, 128, 16, 0)]
    reset_launches()
    mamba_scan(*arrs)
    assert launches() == {"mamba_scan": 0}
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_cuda(*arrs)
    assert launches() == {"mamba_scan": 0}
