"""The port's legacy DANA-Zero master round against the JAX package's.

* The plain version (``ref.py``) equals the eager JAX reference
  (``jax.disable_jit()``) BIT FOR BIT on float32 leaves: the same f32
  operations in the same order, with ``lr * gamma`` formed as one f32
  product of f32 scalars in both.
* Against the JAX Pallas kernel run as the JAX package's own tests run
  it on the CPU (``interpret=True``, under jit): rtol=atol=1e-6 in
  float32 (XLA contracts a*b+c into FMAs inside the jitted kernel) and
  2e-2 in bfloat16 (the tolerance of ``tests/test_kernels.py``: the two
  libraries round bfloat16 intermediates at other places).
* On CPU tensors the wrapper takes the plain version and launches
  nothing; the CUDA-only kernel wrapper refuses CPU tensors (no
  fallback).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dana_update.kernel import dana_master_update_2d
from repro.kernels.dana_update.ops import dana_master_update as jops
from repro.kernels.dana_update.ref import dana_master_update_ref as jref

from repro_torch.kernels.dana_update import (dana_master_update,
                                             dana_master_update_ref,
                                             launches, reset_launches)
from repro_torch.kernels.dana_update.kernel import dana_master_update_cuda
from repro_torch.kernels.dana_update.ref import host_scalars

torch.set_num_threads(1)

LR, GAMMA = 0.05, 0.9


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _to_float(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("rows", [1, 8, 256, 512])
def test_plain_version_f32_bit_equal_to_eager_jax(rows):
    arrs = _inputs((rows, 128), rows)
    port = dana_master_update_ref(*map(torch.from_numpy, arrs), LR, GAMMA)
    with jax.disable_jit():
        eager = jref(*map(jnp.asarray, arrs), LR, GAMMA)
    for a, b in zip(port, eager):
        _bits_equal(a, b)
    pallas = dana_master_update_2d(*map(jnp.asarray, arrs), LR, GAMMA,
                                   interpret=True)
    for a, b in zip(port, pallas):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("rows", [1, 8, 256, 512])
def test_plain_version_bf16_against_jax(rows):
    arrs = _inputs((rows, 128), 100 + rows)
    port = dana_master_update_ref(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrs), LR, GAMMA)
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    refs = jref(*jin, LR, GAMMA)
    pallas = dana_master_update_2d(*jin, LR, GAMMA, interpret=True)
    for a, r, p in zip(port, refs, pallas):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_to_float(a), _to_float(r), rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(_to_float(a), _to_float(p), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("n", [17, 128, 1000, 4096])
def test_tree_wrapper_on_ragged_leaves(n):
    """Leaves of any length (no row padding), one round per leaf."""
    rng = np.random.default_rng(n)

    def tree():
        return {"a": rng.standard_normal(n).astype(np.float32),
                "b": rng.standard_normal((3, 5)).astype(np.float32)}

    trees = [tree() for _ in range(4)]
    reset_launches()
    port = dana_master_update(
        *({k: torch.from_numpy(v) for k, v in t.items()} for t in trees),
        np.float32(0.1), GAMMA)
    assert launches() == {"dana_master_update": 0}
    jt = [jax.tree.map(jnp.asarray, t) for t in trees]
    pallas = jops(*jt, 0.1, GAMMA, use_pallas=True)   # padded, interpret
    with jax.disable_jit():
        eager = jops(*jt, 0.1, GAMMA, use_pallas=False)
    for p_tree, j_tree, e_tree in zip(port, pallas, eager):
        for key in ("a", "b"):
            assert tuple(p_tree[key].shape) == trees[0][key].shape
            _bits_equal(p_tree[key], e_tree[key])
            np.testing.assert_allclose(p_tree[key].numpy(),
                                       np.asarray(j_tree[key]), rtol=1e-6,
                                       atol=1e-6)


def test_scalars_are_formed_in_the_leaf_type():
    """lr*gamma is one product of the leaf type's scalars, as the JAX
    reference forms it; a Python-float product rounds differently."""
    lr, gamma, lrg = host_scalars(LR, GAMMA, torch.float32)
    assert (type(lr), type(gamma)) == (np.float32, np.float32)
    assert lrg == np.float32(LR) * np.float32(GAMMA)
    assert float(lrg) == float(jnp.asarray(LR, jnp.float32)
                               * jnp.asarray(GAMMA, jnp.float32))
    assert float(lrg) != LR * GAMMA
    _, _, lrg_b = host_scalars(LR, GAMMA, torch.bfloat16)
    assert lrg_b == float(jnp.asarray(LR, jnp.bfloat16)
                          * jnp.asarray(GAMMA, jnp.bfloat16))
    with pytest.raises(TypeError):
        host_scalars(LR, GAMMA, torch.float16)


def test_cuda_wrapper_refuses_cpu_tensors_and_launches_nothing():
    x = torch.zeros(8)
    reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        dana_master_update_cuda(x, x, x, x, LR, GAMMA)
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="device"):
        dana_master_update([meta], [meta], [meta], [meta], LR, GAMMA)
    assert launches() == {"dana_master_update": 0}
