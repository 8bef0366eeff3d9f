"""The port's Mixture-of-Experts layer against the JAX package's.

On the JAX package's weights (``jax init_moe`` carried across with
``convert.params_from_numpy``), inputs from numpy seeds, float32:

* The counterparts of JAX ``tests/test_moe.py``: dispatch equals
  dense-all when capacity does not bind (``capacity_factor = E/k``), in
  outputs (2e-5), aux (1e-5) and gradients (5e-4 / 5e-5); a tiny
  capacity drops tokens; the shared expert is added.
* ``_router``: the routes (``top_i``) equal JAX's, compared first, then
  the top-k probabilities within 1e-6 and the aux within 1e-5 relative.
* ``apply_moe_dense_all`` and ``apply_moe_dispatch`` against JAX: routes
  equal, outputs within 1e-5, aux within 1e-5 relative, at capacity 0.25
  and 1.25 (where tokens drop) and E/k, with a shared expert, and with a
  ragged S (one group of S).
* The dispatch tensor (the first einsum's operand in the JAX function)
  equals the port's bit for bit, so the same tokens drop; combine within
  1e-6.
* The capacity is Python's ``round`` of g k / E cf (half to even): 2.5
  gives 2, as llama4-scout's 32-token Engine bucket gives.
* Gradients of a loss over the dispatch output against ``jax.grad``
  within 1e-5 (absolute on leaves of magnitude about 1), the router's
  included (through top-p and the aux).
* ``convert`` carries a JAX MoE model's leaves and a JAX int8 cache
  leaf by leaf, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as jmlp

from repro_torch.convert import params_from_numpy
from repro_torch.core.types import tree_flatten, tree_unflatten
from repro_torch.models import mlp

torch.set_num_threads(1)

OUT_TOL = dict(rtol=0.0, atol=1e-5)
AUX_REL = 1e-5
GRAD_TOL = dict(rtol=0.0, atol=1e-5)


def _setup(e=4, k=2, b=2, s=16, d=32, ff=64, seed=0, shared=False):
    jp = jmlp.init_moe(jax.random.PRNGKey(seed), d, ff, e,
                       shared_expert=shared)
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, d)).astype(np.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), x


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the counterparts of tests/test_moe.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (8, 2)])
def test_dispatch_matches_dense_when_capacity_unbounded(e, k):
    _, p, x = _setup(e=e, k=k)
    xt = torch.from_numpy(x)
    yd, aux_d = mlp.apply_moe_dispatch(p, xt, e, k, capacity_factor=e / k)
    yo, aux_o = mlp.apply_moe_dense_all(p, xt, e, k)
    np.testing.assert_allclose(_np(yd), _np(yo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux_d), float(aux_o), rtol=1e-5)


def _grads(p, fn):
    leaves, td = tree_flatten(p)
    xs = [l.detach().requires_grad_(True) for l in leaves]
    loss = fn(tree_unflatten(td, xs))
    return tree_unflatten(td, list(torch.autograd.grad(loss, xs)))


def test_dispatch_gradients_match_dense():
    e, k = 4, 2
    _, p, x = _setup(e=e, k=k)
    xt = torch.from_numpy(x)

    def loss(fn):
        def f(q):
            y, aux = fn(q)
            return torch.sum(torch.square(y)) + aux
        return f
    gd = _grads(p, loss(lambda q: mlp.apply_moe_dispatch(
        q, xt, e, k, capacity_factor=e / k)))
    go = _grads(p, loss(lambda q: mlp.apply_moe_dense_all(q, xt, e, k)))
    for key in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(_np(gd[key]), _np(go[key]), rtol=5e-4,
                                   atol=5e-5)


def test_capacity_drops_tokens():
    e, k = 4, 1
    _, p, x = _setup(e=e, k=k, s=32)
    xt = torch.from_numpy(x)
    yd, _ = mlp.apply_moe_dispatch(p, xt, e, k, capacity_factor=0.25)
    yo, _ = mlp.apply_moe_dense_all(p, xt, e, k)
    assert np.all(np.isfinite(_np(yd)))
    assert not np.allclose(_np(yd), _np(yo), atol=1e-4)


def test_shared_expert_added():
    e, k = 4, 1
    _, p, x = _setup(e=e, k=k, shared=True)
    xt = torch.from_numpy(x)
    y, _ = mlp.apply_moe_dispatch(p, xt, e, k, capacity_factor=e / k)
    p2 = dict(p)
    p2.pop("shared")
    y2, _ = mlp.apply_moe_dispatch(p2, xt, e, k, capacity_factor=e / k)
    assert not np.allclose(_np(y), _np(y2))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (8, 3), (40, 8)])
def test_router_matches_jax(e, k):
    jp, p, x = _setup(e=e, k=k, s=24, d=48, seed=e + k)
    jt_p, jt_i, jaux = jmlp._router(jp, jnp.asarray(x), e, k)
    top_p, top_i, aux = mlp._router(p, torch.from_numpy(x), e, k)
    assert np.array_equal(top_i.numpy(), np.asarray(jt_i))
    np.testing.assert_allclose(_np(top_p), np.asarray(jt_p), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_REL)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (8, 2)])
def test_dense_all_matches_jax(e, k, shared):
    jp, p, x = _setup(e=e, k=k, seed=3, shared=shared)
    jy, jaux = jmlp.apply_moe_dense_all(jp, jnp.asarray(x), e, k)
    y, aux = mlp.apply_moe_dense_all(p, torch.from_numpy(x), e, k)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **OUT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_REL)


def _jax_dispatch(monkeypatch, jp, x, e, k, cf):
    """JAX ``apply_moe_dispatch`` with its dispatch and combine operands
    read off its einsums."""
    seen = {}
    real = jnp.einsum

    def recording(spec, *ops, **kw):
        if spec == "gsec,gsd->gecd":
            seen["dispatch"] = np.asarray(ops[0])
        if spec == "gsec,gecd->gsd":
            seen["combine"] = np.asarray(ops[0])
        return real(spec, *ops, **kw)
    monkeypatch.setattr(jmlp.jnp, "einsum", recording)
    jy, jaux = jmlp.apply_moe_dispatch(jp, jnp.asarray(x), e, k,
                                       capacity_factor=cf)
    monkeypatch.setattr(jmlp.jnp, "einsum", real)
    return np.asarray(jy), float(jaux), seen


@pytest.mark.parametrize("cf", [0.25, 1.25, None], ids=["cf0.25", "cf1.25",
                                                         "cfE/k"])
@pytest.mark.parametrize("e,k,s,shared", [
    (4, 1, 32, False), (4, 2, 32, True), (8, 2, 64, False),
    (4, 2, 300, False)], ids=["e4k1", "e4k2-shared", "e8k2", "ragged300"])
def test_dispatch_matches_jax_and_drops_the_same_tokens(monkeypatch, e, k,
                                                        s, shared, cf):
    cf = e / k if cf is None else cf
    jp, p, x = _setup(e=e, k=k, s=s, seed=s + e, shared=shared)
    _, jt_i, _ = jmlp._router(jp, jnp.asarray(x), e, k)
    top_p, top_i, _ = mlp._router(p, torch.from_numpy(x), e, k)
    assert np.array_equal(top_i.numpy(), np.asarray(jt_i))
    jy, jaux, seen = _jax_dispatch(monkeypatch, jp, x, e, k, cf)
    y, aux = mlp.apply_moe_dispatch(p, torch.from_numpy(x), e, k,
                                    capacity_factor=cf)
    np.testing.assert_allclose(_np(y), jy, **OUT_TOL)
    np.testing.assert_allclose(float(aux), jaux, rtol=AUX_REL)
    g, ng, cap = mlp.moe_capacity(s, e, k, cf)
    b = x.shape[0]
    dispatch, combine = mlp.dispatch_tensors(
        top_p.reshape(b * ng, g, k), top_i.reshape(b * ng, g, k), e, cap,
        torch.float32)
    assert dispatch.shape == seen["dispatch"].shape == (b * ng, g, e, cap)
    assert np.array_equal(dispatch.numpy(), seen["dispatch"])
    np.testing.assert_allclose(combine.numpy(), seen["combine"], rtol=0,
                               atol=1e-6)
    kept = float(dispatch.sum())
    if cf < 1:
        assert kept < b * s * k          # tokens dropped, the same ones
    if cf == e / k:
        assert kept == b * s * k         # nothing dropped


def test_capacity_rounds_half_to_even_on_the_host(monkeypatch):
    """g k / E cf = 32 * 1 / 16 * 1.25 = 2.5 -> 2 (Python's round), the
    capacity of llama4-scout (16 experts, top-1) at a 32-token bucket;
    1.5 -> 2; a ragged S is one group of S; at least 1."""
    assert mlp.moe_capacity(32, 16, 1, 1.25) == (32, 1, 2)
    assert mlp.moe_capacity(24, 16, 1, 1.0) == (24, 1, 2)      # 1.5
    assert mlp.moe_capacity(512, 40, 8, 1.25) == (256, 2, 64)
    assert mlp.moe_capacity(512, 16, 1, 1.25) == (256, 2, 20)
    assert mlp.moe_capacity(300, 4, 2, 1.25) == (300, 1, 188)
    assert mlp.moe_capacity(1, 16, 1, 1.25) == (1, 1, 1)
    jp, p, x = _setup(e=16, k=1, s=32, d=32, seed=9)
    jy, _, seen = _jax_dispatch(monkeypatch, jp, x, 16, 1, 1.25)
    assert seen["dispatch"].shape[-1] == 2
    y, _ = mlp.apply_moe_dispatch(p, torch.from_numpy(x), 16, 1)
    np.testing.assert_allclose(_np(y), jy, **OUT_TOL)


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_dispatch_gradients_match_jax_grad(cf):
    e, k = 4, 2
    jp, p, x = _setup(e=e, k=k, s=32, seed=11, shared=True)
    w = np.random.default_rng(12).standard_normal(x.shape).astype(
        np.float32)

    def jloss(q):
        y, aux = jmlp.apply_moe_dispatch(q, jnp.asarray(x), e, k,
                                         capacity_factor=cf)
        return jnp.sum(y * w) + aux

    jg = jax.grad(jloss)(jp)
    g = _grads(p, lambda q: (lambda y, aux: torch.sum(
        y * torch.from_numpy(w)) + aux)(*mlp.apply_moe_dispatch(
            q, torch.from_numpy(x), e, k, capacity_factor=cf)))
    jl = jax.tree.leaves(jg)
    gl = tree_flatten(g)[0]
    assert len(jl) == len(gl)
    for a, b in zip(jl, gl):
        np.testing.assert_allclose(_np(b), np.asarray(a), **GRAD_TOL)
    assert float(g["router"].abs().max()) > 0


def test_convert_carries_moe_leaves_and_int8_caches():
    """``lm_params_from_numpy`` carries a JAX MoE model's leaves (router,
    stacked experts, shared MLP) and ``params_from_numpy`` a JAX int8
    cache, leaf by leaf in their own types and values."""
    import dataclasses
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    from repro.models.attention import CacheSpec as JSpec
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.core.types import tree_leaves
    jcfg = dataclasses.replace(jget("llama4-scout-17b-a16e").reduced(),
                               vocab_size=64)
    jp = jax.jit(lambda key: jlm.init_lm(key, jcfg))(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    moe = p["unit"][0]["moe"]
    assert set(moe) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert moe["w_gate"].shape == (1, 4, 256, 512)
    assert moe["w_down"].shape == (1, 4, 512, 256)
    assert moe["router"].shape == (1, 256, 4)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(p)):
        assert np.array_equal(np.asarray(a), b.numpy())
    pb = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              torch.bfloat16)
    assert pb["unit"][0]["moe"]["w_up"].dtype == torch.bfloat16
    spec = JSpec(16, None, True)
    _, jc = jax.jit(lambda q, t: jlm.prefill(q, jcfg, {"tokens": t}, spec))(
        jp, jnp.zeros((1, 8), jnp.int32))
    c = params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    kv = c["unit"][0]
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].dtype == \
        torch.float32
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(c)):
        assert np.array_equal(np.asarray(a), b.numpy())
