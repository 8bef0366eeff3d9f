"""The port's 2-D partial RoPE (chatglm3-6b) and M-RoPE (qwen2-vl-7b)
against the JAX package's, and their dispatch in ``apply_rope``.

Inputs from numpy seeds, float32, positions up to 4096 (and M-RoPE's
three rows apart): the rotations agree within 1e-6 (cos and sin of the
same float32 angles, one ulp apart at most; the angles themselves are
the same float32 products).  ``default_mrope_sections`` equals the JAX
function for every head dim tried.  The unrotated half of a 2-D RoPE
head passes through bit for bit, in bfloat16 too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import apply_rope as japply_rope
from repro.models.common import default_mrope_sections as jsections
from repro.models.common import rope_2d_partial as jrope2d
from repro.models.common import rope_mrope as jmrope

from repro_torch.models.attention import apply_rope
from repro_torch.models.common import (default_mrope_sections,
                                       rope_2d_partial, rope_mrope)

ROPE_TOL = dict(rtol=1e-6, atol=1e-6)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _positions(b, s, seed, rows=None):
    rng = np.random.default_rng(seed)
    shape = (b, s) if rows is None else (rows, b, s)
    return rng.integers(0, 4096, size=shape).astype(np.int32)


def _close(out, ref):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               **ROPE_TOL)


@pytest.mark.parametrize("hd", [64, 128])
def test_rope_2d_partial_matches_jax(hd):
    x = _x((2, 9, 3, hd), hd)
    pos = _positions(2, 9, 1)
    out = rope_2d_partial(torch.from_numpy(x), torch.from_numpy(pos))
    _close(out, jrope2d(jnp.asarray(x), jnp.asarray(pos)))
    # the second half of every head carries no positional signal
    assert torch.equal(out[..., hd // 2:], torch.from_numpy(x)[..., hd // 2:])
    xb = torch.from_numpy(x).bfloat16()
    outb = rope_2d_partial(xb, torch.from_numpy(pos))
    assert outb.dtype == torch.bfloat16
    assert torch.equal(outb[..., hd // 2:], xb[..., hd // 2:])


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_rope_mrope_matches_jax(hd):
    x = _x((2, 7, 4, hd), hd + 1)
    pos3 = _positions(2, 7, 2, rows=3)
    sec = default_mrope_sections(hd)
    out = rope_mrope(torch.from_numpy(x), torch.from_numpy(pos3), sec)
    _close(out, jmrope(jnp.asarray(x), jnp.asarray(pos3), sec))


def test_rope_mrope_default_sections_and_equal_rows_are_rope_1d():
    """With the JAX default sections (16, 24, 24) at hd 128, and with
    three equal position rows M-RoPE is the 1-D rotation of its bands."""
    x = _x((1, 5, 2, 128), 3)
    pos3 = _positions(1, 5, 4, rows=3)
    _close(rope_mrope(torch.from_numpy(x), torch.from_numpy(pos3)),
           jmrope(jnp.asarray(x), jnp.asarray(pos3)))
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    from repro_torch.models.common import rope_1d
    a = rope_mrope(torch.from_numpy(x), torch.from_numpy(same))
    b = rope_1d(torch.from_numpy(x), torch.from_numpy(same[0]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
def test_default_mrope_sections_match_jax(hd):
    sec = default_mrope_sections(hd)
    assert sec == tuple(jsections(hd))
    assert sum(sec) == hd // 2


@pytest.mark.parametrize("rope", ["2d", "mrope"])
def test_apply_rope_dispatch_matches_jax(rope):
    """``apply_rope`` rotates q and k with the config's variant (M-RoPE
    with the default sections of the head dim)."""
    q, k = _x((2, 6, 4, 64), 5), _x((2, 6, 2, 64), 6)
    pos = _positions(2, 6, 7, rows=3 if rope == "mrope" else None)
    oq, ok = apply_rope(torch.from_numpy(q), torch.from_numpy(k), rope,
                        torch.from_numpy(pos))
    jq, jk = japply_rope(jnp.asarray(q), jnp.asarray(k), rope,
                         jnp.asarray(pos))
    _close(oq, jq)
    _close(ok, jk)
