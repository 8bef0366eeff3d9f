"""The port's CUDA kernels against their plain versions on a card.

Marked ``gpu``: each test skips without a CUDA device (and needs
``nvcc``, which builds the kernel at first use).  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import (launches, mamba_scan,
                                            mamba_scan_ref, reset_launches)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scan_inputs(b, s, d, n, seed, device):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    delta = np.logaddexp(randn(b, s, d), 0.0).astype(np.float32) * 0.1
    arrs = (randn(b, s, d), delta, randn(b, s, n), randn(b, s, n),
            -np.abs(randn(d, n)), randn(b, d, n))
    return [torch.from_numpy(a).to(device) for a in arrs]


@pytest.mark.parametrize("b,s,d,n", [(1, 8, 128, 16), (2, 32, 128, 16),
                                     (1, 16, 256, 8), (4, 1, 8192, 16),
                                     (2, 77, 200, 16), (1, 130, 64, 8)])
def test_mamba_scan_kernel_matches_plain_version(cuda, b, s, d, n):
    """The state to 1e-6 (the same rounded operations), y to 1e-5 (the
    N-sum in another order); one launch per call."""
    arrs = _scan_inputs(b, s, d, n, s + d, cuda)
    reset_launches()
    y, last = mamba_scan(*arrs)
    assert launches() == {"mamba_scan": 1}
    ry, rlast = mamba_scan_ref(*arrs)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last, rlast, rtol=1e-6, atol=1e-6)


def test_mamba_scan_kernel_refuses_what_it_does_not_take(cuda):
    x, dl, bm, cm, a, h0 = _scan_inputs(1, 4, 64, 16, 0, cuda)
    with pytest.raises(TypeError):
        mamba_scan(x.double(), dl, bm, cm, a, h0)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(x, dl, bm.transpose(1, 2).contiguous().transpose(1, 2),
                   cm, a, h0)
    x4, dl4, bm4, cm4, a4, h04 = _scan_inputs(1, 4, 64, 4, 0, cuda)
    with pytest.raises(ValueError, match="N in"):
        mamba_scan(x4, dl4, bm4, cm4, a4, h04)
