"""The port's RG-LRU scan against the JAX package's.

* The plain version (``ref.py``) against the JAX reference
  ``rglru_scan_ref`` and against the Pallas kernel run as the JAX
  package's own tests run it on the CPU (``interpret=True``), at the
  shapes of ``tests/test_kernels.py``, float32 and bfloat16, with the JAX
  package's tolerances: 1e-5 at float32 (the same rounded products and
  sums; measured 0), 5e-2 at bfloat16 (XLA may keep a fused step in
  float32 and round once where PyTorch rounds the product and the sum).
* A scan split into two calls chained through the last state equals one
  call bit for bit; S = 1 (a decode step) and S = 0 work.
* On CPU tensors the wrapper takes the plain version and launches
  nothing; the CUDA-only kernel wrapper refuses CPU tensors (no
  fallback).  The kernel itself is held bit for bit against the plain
  version on a card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.kernel import rglru_scan_pallas
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jref

from repro_torch.kernels.rglru_scan import (launches, reset_launches,
                                            rglru_scan, rglru_scan_ref)
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda

torch.set_num_threads(1)

SHAPES = [(1, 8, 128), (2, 64, 128), (2, 32, 256)]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, d, seed):
    """a in (0, 1) (a sigmoid, as the gate makes it), x and h0 normal."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))
    return (a.astype(np.float32),
            rng.standard_normal((b, s, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


def _port(arrs, dtype="float32"):
    return rglru_scan(*(torch.from_numpy(a).to(TORCH_DT[dtype])
                        for a in arrs))


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


@pytest.mark.parametrize("b,s,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_reference_and_pallas(b, s, d, dtype):
    arrs = _inputs(b, s, d, s + d)
    out, last = _port(arrs, dtype)
    assert out.dtype == last.dtype == TORCH_DT[dtype]
    jarrs = [jnp.asarray(a).astype(dtype) for a in arrs]
    rout, rlast = jref(*jarrs)
    pout, plast = rglru_scan_pallas(*jarrs, seq_chunk=min(16, s),
                                    interpret=True)
    for ref_out, ref_last in ((rout, rlast), (pout, plast)):
        np.testing.assert_allclose(_np(out), _np(ref_out), **TOL[dtype])
        np.testing.assert_allclose(_np(last), _np(ref_last), **TOL[dtype])


def test_chained_calls_equal_one_call_bit_for_bit():
    a, x, h0 = map(torch.from_numpy, _inputs(2, 48, 128, 7))
    out, last = rglru_scan(a, x, h0)
    o1, mid = rglru_scan(a[:, :20], x[:, :20], h0)
    o2, last2 = rglru_scan(a[:, 20:], x[:, 20:], mid)
    assert torch.equal(torch.cat([o1, o2], 1), out)
    assert torch.equal(last2, last)


def test_single_step_and_empty_sequence():
    a, x, h0 = map(torch.from_numpy, _inputs(3, 1, 64, 8))
    out, last = rglru_scan(a, x, h0)
    assert torch.equal(out[:, 0], a[:, 0] * h0 + x[:, 0])
    assert torch.equal(last, out[:, 0])
    out0, last0 = rglru_scan(a[:, :0], x[:, :0], h0)
    assert out0.shape == (3, 0, 64) and torch.equal(last0, h0)


def test_cpu_tensors_take_the_plain_version():
    arrs = list(map(torch.from_numpy, _inputs(1, 4, 32, 9)))
    reset_launches()
    out, last = rglru_scan(*arrs)
    assert launches() == {"rglru_scan": 0}
    rout, rlast = rglru_scan_ref(*arrs)
    assert torch.equal(out, rout) and torch.equal(last, rlast)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_cuda(*arrs)
