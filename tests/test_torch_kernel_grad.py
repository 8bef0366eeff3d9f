"""Gradients through the port's scan and attention wrappers.

On the card ``ops.mamba_scan``, ``ops.rglru_scan`` and
``ops.swa_attention`` send a call that needs a gradient through
``kernels/_autograd.KernelFunction``: the CUDA kernel forward, the
gradient of the plain version (recomputed on detached inputs) backward.
The forward is an argument of the Function, so here, without a card, the
same Function runs with the plain version as its forward:

* its input gradients equal autograd through the plain version bit for
  bit (the backward is that autograd), and agree with ``jax.grad`` of
  the JAX package's ``*_ref`` run eagerly (``jax.disable_jit()``) in
  float32 to rtol 1e-5 and an atol of 1e-6 times the gradient's largest
  magnitude (the same operations, summed in other orders by the two
  frameworks' backward passes: a sum of terms near 10 that cancels to
  near 0 keeps their absolute error, about 1e-6);
* attention with K < H: the gradients of K and V sum over each group of
  query heads back to (B,S,K,hd), with a window below S and one at least
  S (plain causal);
* the Function calls its forward once and never in the backward; a call
  that needs no gradient records no graph (serving is unchanged);
* one reduced LM per family (falcon-mamba-7b-reduced,
  recurrentgemma-9b-reduced) in float32: with grad enabled every
  parameter leaf gets a finite gradient, and routing every scan and
  attention call through the Function (plain forward) gives the same
  gradients bit for bit.  The card's gradients against the CPU's are
  ``chip_smoke.py``'s ``lm_grad`` phase and ``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import mamba_scan_ref as jmamba
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jrglru
from repro.kernels.swa_attention.ops import swa_attention as jswa

from repro_torch.configs import get_config
from repro_torch.core.types import tree_leaves
from repro_torch.kernels import _autograd
from repro_torch.kernels.mamba_scan import mamba_scan_ref
from repro_torch.kernels.rglru_scan import rglru_scan_ref
from repro_torch.kernels.swa_attention import swa_attention_gqa
from repro_torch.models import attention, recurrent
from repro_torch.models.api import build_model

torch.set_num_threads(1)

JAX_RTOL, JAX_ATOL_OF_MAX = 1e-5, 1e-6


def _rng_arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _leaves(arrs):
    return [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrs]


def _weighted(outs, ws):
    outs = outs if isinstance(outs, tuple) else (outs,)
    return sum((o * w).sum() for o, w in zip(outs, ws))


def _function_grads(plain, arrs, ws, static=()):
    """Input gradients through KernelFunction with ``plain`` forward."""
    xs = _leaves(arrs)
    out = _autograd.KernelFunction.apply(plain, plain, tuple(static), *xs)
    _weighted(out, [torch.from_numpy(w) for w in ws]).backward()
    return [x.grad for x in xs]


def _plain_grads(plain, arrs, ws, static=()):
    xs = _leaves(arrs)
    _weighted(plain(*xs, *static), [torch.from_numpy(w) for w in ws]) \
        .backward()
    return [x.grad for x in xs]


def _jax_grads(jfn, arrs, ws):
    def loss(*xs):
        outs = jfn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))
    with jax.disable_jit():
        return jax.grad(loss, argnums=tuple(range(len(arrs))))(
            *[jnp.asarray(a) for a in arrs])


def _check(plain, jfn, arrs, ws, static=()):
    got = _function_grads(plain, arrs, ws, static)
    want = _plain_grads(plain, arrs, ws, static)
    jgot = _jax_grads(jfn, arrs, ws)
    for i, (g, w, j) in enumerate(zip(got, want, jgot)):
        assert g is not None and tuple(g.shape) == arrs[i].shape, i
        assert torch.equal(g, w), i
        j = np.asarray(j)
        np.testing.assert_allclose(
            g.numpy(), j, rtol=JAX_RTOL,
            atol=JAX_ATOL_OF_MAX * float(np.abs(j).max()),
            err_msg=f"input {i}")


# ---------------------------------------------------------------------------
# the three kernels
# ---------------------------------------------------------------------------
def _mamba_inputs(b, s, d, n, seed):
    x, dt, bm, cm, a, h0 = _rng_arrays(
        seed, [(b, s, d), (b, s, d), (b, s, n), (b, s, n), (d, n),
               (b, d, n)])
    delta = (np.logaddexp(dt, 0.0) * 0.1).astype(np.float32)
    return [x, delta, bm, cm, -np.abs(a), h0]


@pytest.mark.parametrize("b,s,d,n", [(2, 12, 16, 8), (1, 9, 24, 16)])
def test_mamba_scan_function_gradients(b, s, d, n):
    arrs = _mamba_inputs(b, s, d, n, seed=s + d)
    ws = _rng_arrays(7, [(b, s, d), (b, d, n)])
    _check(mamba_scan_ref, jmamba, arrs, ws)


@pytest.mark.parametrize("b,s,d", [(2, 16, 32), (1, 33, 7)])
def test_rglru_scan_function_gradients(b, s, d):
    a, x, h0 = _rng_arrays(s + d, [(b, s, d), (b, s, d), (b, d)])
    a = (1.0 / (1.0 + np.exp(-a))).astype(np.float32)
    ws = _rng_arrays(8, [(b, s, d), (b, d)])
    _check(rglru_scan_ref, jrglru, [a, x, h0], ws)


@pytest.mark.parametrize("b,s,h,kh,hd,window", [
    (2, 24, 4, 1, 16, 8),        # MQA, window below S
    (1, 20, 4, 2, 8, 64),        # GQA, window at least S (plain causal)
    (1, 17, 3, 3, 12, 5)])       # K = H, S no multiple of anything
def test_swa_attention_function_gradients(b, s, h, kh, hd, window):
    arrs = _rng_arrays(s + h + window,
                       [(b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)])
    ws = _rng_arrays(9, [(b, s, h, hd)])
    _check(swa_attention_gqa, lambda q, k, v: jswa(q, k, v, window,
                                                   use_pallas=False),
           arrs, ws, static=(window,))


def test_function_runs_its_forward_once_and_records_no_graph_unneeded():
    calls = {"kernel": 0, "plain": 0}

    def kernel(a, x, h0):
        calls["kernel"] += 1
        return rglru_scan_ref(a, x, h0)

    def plain(a, x, h0):
        calls["plain"] += 1
        return rglru_scan_ref(a, x, h0)

    a, x, h0 = (torch.from_numpy(t) for t in _rng_arrays(
        3, [(1, 5, 4), (1, 5, 4), (1, 4)]))
    h_all, last = _autograd.apply(kernel, plain, (a, x, h0))
    assert h_all.grad_fn is None and calls == {"kernel": 1, "plain": 0}
    x.requires_grad_(True)
    with torch.no_grad():
        h_all, _ = _autograd.apply(kernel, plain, (a, x, h0))
    assert h_all.grad_fn is None and calls == {"kernel": 2, "plain": 0}
    h_all, last = _autograd.apply(kernel, plain, (a, x, h0))
    assert type(h_all.grad_fn).__name__ == "KernelFunctionBackward"
    assert calls == {"kernel": 3, "plain": 0}
    (h_all.sum() + last.sum()).backward()
    assert calls == {"kernel": 3, "plain": 1}
    assert x.grad is not None and a.grad is None and h0.grad is None


# ---------------------------------------------------------------------------
# reduced LMs
# ---------------------------------------------------------------------------
def _lm_grads(arch, seq, via_function, monkeypatch):
    """float32 parameters from a seeded generator, tokens and the loss
    weights W from numpy: gradients of sum(logits * W)."""
    if via_function:
        def through(plain, static_argnums=()):
            def call(*args, **kw):
                # keyword arguments (attention's causal flag and segments)
                # follow the static positional ones, as the wrapper passes
                tensors = [a for i, a in enumerate(args)
                           if i not in static_argnums]
                static = [a for i, a in enumerate(args)
                          if i in static_argnums] + list(kw.values())
                return _autograd.KernelFunction.apply(
                    plain, plain, tuple(static), *tensors)
            return call
        monkeypatch.setattr(recurrent, "mamba_scan",
                            through(mamba_scan_ref))
        monkeypatch.setattr(recurrent, "rglru_scan",
                            through(rglru_scan_ref))
        monkeypatch.setattr(attention, "swa_attention",
                            through(swa_attention_gqa, (3,)))
    cfg = get_config(arch).reduced()
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, seq))
                            .astype(np.int32))
    w = torch.from_numpy(rng.standard_normal(
        (2, seq, cfg.vocab_size)).astype(np.float32))
    logits, _ = model.forward(params, {"tokens": toks})
    (logits * w).sum().backward()
    return [leaf.grad for leaf in tree_leaves(params)]


@pytest.mark.parametrize("arch,seq", [("falcon-mamba-7b", 24),
                                      ("recurrentgemma-9b", 80)])
def test_reduced_lm_every_leaf_gets_a_gradient(arch, seq, monkeypatch):
    """recurrentgemma's 80 tokens pass its reduced window of 64."""
    plain = _lm_grads(arch, seq, False, monkeypatch)
    assert plain and all(g is not None and bool(torch.isfinite(g).all())
                         for g in plain)
    assert all(float(g.abs().max()) > 0 for g in plain)
    via = _lm_grads(arch, seq, True, monkeypatch)
    assert len(via) == len(plain)
    for g, p in zip(via, plain):
        assert torch.equal(g, p)
