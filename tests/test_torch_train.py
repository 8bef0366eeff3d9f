"""The port's LM training path against the JAX package's.

On qwen2-1.5b reduced with 2 unit repeats (2 ``attn`` layers, d_model
256, 4 heads, 2 kv heads, head_dim 64, qkv bias, vocab 512), on the JAX
package's weights (``convert.lm_params_from_numpy``), inputs from numpy
seeds:

* ``softmax_xent_logits`` against JAX's, with and without a mask and
  -1 labels: rtol 1e-6 (float32 logsumexp and gather).
* ``LMTask`` (and ``lm_batches``, ``classification_batches``): batches
  bit-equal to the JAX task's (the same ``_fold`` numpy streams).
* The dense ``attn`` kind (full causal attention through
  ``swa_attention`` with a window of S): forward, prefill and two decode
  steps at float32 within 1e-4 (measured about 5e-6), with a full cache
  and with a sliding-window spec (decode steps from each side's own
  bfloat16 KV cache within 1e-3, from the JAX cache within 1e-4); the
  default bfloat16 path within 0.15 (C8; measured about 0.04).
* ``lm_loss`` at float32 against JAX ``softmax_xent_logits(forward(...,
  dtype=float32))`` within 1e-5 (measured: equal), and its float32
  gradients against ``jax.grad`` within 1e-4 relative L2 per leaf
  (measured about 1e-6).
* ``ModelGradFn`` (bfloat16 forward from float32 parameters) against the
  JAX ``ModelGradFn``: per-leaf relative L2 within 0.05 (measured 0.007
  to 0.017: the two bfloat16 paths round differently, C8); it pickles
  and refuses a larger mesh (A8).
* The pod-round step: pods=1 for 3 steps against the JAX package's
  jitted ``build_train_step`` on a (1, 1, 1) pod mesh (losses within
  5e-3, measured 1e-3; theta within 5e-4 absolute, measured 2e-4;
  momenta within 0.05 relative L2 per leaf, measured 0.018); pods=2
  against the JAX model's per-pod ``value_and_grad`` at the bfloat16
  look-ahead composed with the step's algebra in numpy (the same
  bounds); microbatches=2 against 1; ``v0 == sum_p v_p`` bit for bit.
* ``launch.train.main`` learns, and a run resumed from its checkpoint
  ends bit for bit where the uninterrupted run ends (CPU).
* ``launch.cluster --preset lm`` deterministic equals the port's engine
  bit for bit; ``launch.serve --arch qwen2-1.5b --reduced`` generates.
"""
import dataclasses
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro.models.api import ModelGradFn as JModelGradFn
from repro.models.api import build_model as jbuild
from repro.models.attention import CacheSpec as JSpec
from repro.models.common import softmax_xent_logits as jxent

from repro_torch.checkpoint import load_pytree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, params_from_numpy
from repro_torch.core.types import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data import synthetic
from repro_torch.launch import cluster as cluster_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import blocks, lm
from repro_torch.models.api import (TINY_LM_OVERRIDES, ModelGradFn,
                                    build_model)
from repro_torch.models.attention import CacheSpec
from repro_torch.models.common import softmax_xent_logits

torch.set_num_threads(1)

F32_TOL = dict(rtol=0.0, atol=1e-4)
OWN_CACHE_TOL = dict(rtol=0.0, atol=1e-3)     # see the prefill/decode test
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-5)     # one bfloat16 step
BF16_TOL = dict(rtol=0.0, atol=0.15)
LOSS_F32_TOL = dict(rtol=0.0, atol=1e-5)
GRAD_F32_REL = 1e-4
GRAD_BF16_REL = 0.05          # per leaf, relative L2
STEP_LOSS_TOL = 5e-3          # pod-round step losses, absolute
THETA_TOL = 5e-4              # theta after the steps, absolute
MOMENTUM_REL = 0.05           # v and v0, relative L2 per leaf
SEQ = 64


def _two(c):
    return dataclasses.replace(c.reduced(), unit_repeats=2, num_layers=2)


def _tiny(c):
    return dataclasses.replace(c.reduced(), **TINY_LM_OVERRIDES)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _two(jget("qwen2-1.5b")), _two(get_config("qwen2-1.5b"))
    jp = jax.jit(lambda k: jlm.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _tokens(vocab, s, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(b, s)).astype(np.int32)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _labels(toks):
    return np.concatenate([toks[:, 1:], np.full((toks.shape[0], 1), -1,
                                                np.int32)], axis=1)


def _jloss32(jcfg):
    def loss(params, toks):
        logits, aux = jlm.forward(params, jcfg, {"tokens": toks},
                                  dtype=jnp.float32)
        labels = jnp.concatenate(
            [toks[:, 1:], jnp.full((toks.shape[0], 1), -1, jnp.int32)], 1)
        return jxent(logits, labels) + 0.01 * aux
    return loss


# ---------------------------------------------------------------------------
# the loss and the data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True], ids=["labels", "mask"])
def test_softmax_xent_logits_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((3, 17, 40))).astype(np.float32)
    labels = rng.integers(0, 40, size=(3, 17)).astype(np.int32)
    labels[:, -1] = -1
    labels[1, 3:6] = -1
    mask = (rng.random((3, 17)) < 0.7).astype(np.float32) if masked \
        else None
    ref = jxent(jnp.asarray(logits), jnp.asarray(labels),
                None if mask is None else jnp.asarray(mask))
    out = softmax_xent_logits(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.dim() == 0
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    # bfloat16 logits are widened first, as in JAX
    lb = jnp.asarray(logits, jnp.bfloat16)
    np.testing.assert_allclose(
        float(softmax_xent_logits(
            torch.from_numpy(np.asarray(lb, np.float32)).bfloat16(),
            torch.from_numpy(labels))),
        float(jxent(lb, jnp.asarray(labels))), rtol=1e-6)


def test_lm_task_batches_bit_equal_to_jax():
    for kw in (dict(), dict(vocab_size=151, seq_len=33, batch_size=3,
                            seed=5)):
        jt = jsyn.LMTask(**kw)
        t = synthetic.LMTask(**kw, device="cpu")
        for w, c in ((0, 0), (3, 7), (1, 12)):
            b = t.batch(w, c)
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(), np.asarray(jt.batch(w, c)))
        np.testing.assert_array_equal(t.eval_batch(8).numpy(),
                                      np.asarray(jt.eval_batch(8)))
        np.testing.assert_array_equal(
            synthetic.lm_batches(t)(2, 4).numpy(),
            np.asarray(jsyn.lm_batches(jt)(2, 4)))
    ct = synthetic.ClassificationTask(dim=8, batch_size=5, device="cpu")
    jx, jy = jsyn.classification_batches(jsyn.ClassificationTask(
        dim=8, batch_size=5))(1, 2)
    x, y = synthetic.classification_batches(ct)(1, 2)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


# ---------------------------------------------------------------------------
# the dense attn kind
# ---------------------------------------------------------------------------
def test_attn_kind_forward_matches_jax_f32(weights):
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg.vocab_size, SEQ)
    jl, _ = jax.jit(lambda q, t: jlm.forward(
        q, jcfg, {"tokens": t}, dtype=jnp.float32))(jp, jnp.asarray(toks))
    logits, aux = lm.forward(p, cfg, {"tokens": torch.from_numpy(toks)},
                             dtype=torch.float32)
    assert logits.shape == (2, SEQ, cfg.vocab_size) and aux == 0.0
    _close(logits, jl, F32_TOL)


@pytest.mark.parametrize("window", [None, 16], ids=["full", "window16"])
def test_attn_kind_prefill_and_decode_match_jax_f32(weights, window):
    """Prefill SEQ tokens, then two decode steps: last logits, step
    logits, the cache layout and its positions; with a full cache the
    decode logits equal the port's own forward over prompt + tokens.
    Each side decodes from its own bfloat16 KV cache, in which a few
    entries (about 20 of 36,864) round one bfloat16 step apart, so those
    steps are held to 1e-3 (measured up to 3.1e-4); a step from the JAX
    cache carried across is held to 1e-4 (measured 7e-6)."""
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg.vocab_size, SEQ + 2, seed=3)
    cap = SEQ + 8 if window is None else window
    jspec, spec = JSpec(cap, window), CacheSpec(cap, window)
    jl, jc = jax.jit(lambda q, t: jlm.prefill(
        q, jcfg, {"tokens": t}, jspec, dtype=jnp.float32))(
        jp, jnp.asarray(toks[:, :SEQ]))
    jstep = jax.jit(lambda q, t, c: jlm.decode_step(
        q, jcfg, t, c, jspec, dtype=jnp.float32))
    jl2, jc2 = jstep(jp, jnp.asarray(toks[:, SEQ:SEQ + 1]), jc)
    jl3, jc3 = jstep(jp, jnp.asarray(toks[:, SEQ + 1:]), jc2)
    t = torch.from_numpy(toks)
    logits, cache = lm.prefill(p, cfg, {"tokens": t[:, :SEQ]}, spec,
                               dtype=torch.float32)
    l2, c2 = lm.decode_step(p, cfg, t[:, SEQ:SEQ + 1], cache, spec,
                            dtype=torch.float32)
    l3, c3 = lm.decode_step(p, cfg, t[:, SEQ + 1:], c2, spec,
                            dtype=torch.float32)
    _close(logits, jl, F32_TOL)
    for a, b in ((l2, jl2), (l3, jl3)):
        assert a.shape == (2, 1, cfg.vocab_size)
        _close(a, b, OWN_CACHE_TOL)
    # from the JAX cache carried across, the step agrees to 1e-4
    lj, _ = lm.decode_step(p, cfg, t[:, SEQ:SEQ + 1], params_from_numpy(
        jax.tree.map(np.asarray, jc), "cpu"), spec, dtype=torch.float32)
    _close(lj, jl2, F32_TOL)
    for c, jcc in ((cache, jc), (c3, jc3)):
        kv = c["unit"][0]
        assert kv["k"].shape == (2, 2, cap, 2, 64)     # (repeats, B, ...)
        assert kv["k"].dtype == kv["v"].dtype == torch.bfloat16
        for key in ("k", "v"):
            _close(kv[key], np.asarray(jcc["unit"][0][key], np.float32),
                   BF16_ULP)
        np.testing.assert_array_equal(kv["pos"].numpy(),
                                      np.asarray(jcc["unit"][0]["pos"]))
    assert int(c3["t"]) == int(jc3["t"]) == SEQ + 2
    if window is None:
        full, _ = lm.forward(p, cfg, {"tokens": t}, dtype=torch.float32)
        # a bfloat16 KV cache against float32 K and V (C6): measured
        # 9.7e-3 on these logits of magnitude about 4
        torch.testing.assert_close(l3[:, 0], full[:, -1], rtol=0,
                                   atol=0.02)


def test_attn_kind_bf16_matches_jax_bf16(weights):
    jcfg, cfg, jp, _ = weights
    jpb = jax.tree.map(lambda l: l.astype(jnp.bfloat16), jp)
    pb = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              torch.bfloat16)
    toks = _tokens(cfg.vocab_size, SEQ, seed=5)
    jmodel, model = jbuild(jcfg), build_model(cfg)
    jl, _ = jax.jit(jmodel.forward)(jpb, {"tokens": jnp.asarray(toks)})
    logits, _ = model.forward(pb, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.bfloat16
    _close(logits, jl, BF16_TOL)
    jspec, spec = JSpec(SEQ, None), CacheSpec(SEQ, None)
    jl1, jc = jax.jit(lambda q, b: jmodel.prefill(q, b, jspec))(
        jpb, {"tokens": jnp.asarray(toks[:, :-1])})
    l1, c = model.prefill(pb, {"tokens": torch.from_numpy(toks[:, :-1])},
                          spec)
    _close(l1, jl1, BF16_TOL)
    jl2, _ = jax.jit(lambda q, t, cc: jmodel.decode_step(q, t, cc, jspec))(
        jpb, jnp.asarray(toks[:, -1:]), jc)
    l2, _ = model.decode_step(pb, torch.from_numpy(toks[:, -1:]), c, spec)
    _close(l2, jl2, BF16_TOL)


def test_unsupported_attention_kinds_still_raise():
    """The enc-dec kinds, which raised here naming A7 until they were
    ported (test_torch_encdec.py), build with the JAX package's leaves;
    a kind no config names still raises."""
    cfg = get_config("qwen2-1.5b").reduced()
    for kind, extra in (("attn_bidir", set()), ("attn_cross",
                                                {"lnx", "xattn"})):
        p = blocks.init_block(torch.Generator(), cfg, kind, "cpu")
        assert set(p) == {"ln1", "attn", "ln2", "mlp"} | extra
    with pytest.raises(ValueError, match="attn_sparse"):
        blocks.init_block(torch.Generator(), cfg, "attn_sparse", "cpu")


# ---------------------------------------------------------------------------
# the loss, its gradients, ModelGradFn
# ---------------------------------------------------------------------------
def test_lm_loss_matches_jax_f32(weights):
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg.vocab_size, SEQ, seed=6)
    ref = jax.jit(_jloss32(jcfg))(jp, jnp.asarray(toks))
    out = lm.lm_loss(p, cfg, {"tokens": torch.from_numpy(toks)},
                     dtype=torch.float32)
    np.testing.assert_allclose(float(out), float(ref), **LOSS_F32_TOL)
    # the loss is the mean next-token cross entropy of forward's logits
    logits, _ = lm.forward(p, cfg, {"tokens": torch.from_numpy(toks)},
                           dtype=torch.float32)
    assert float(out) == float(softmax_xent_logits(
        logits, torch.from_numpy(_labels(toks))))
    model = build_model(cfg, torch.float32)
    assert float(model.loss(p, {"tokens": torch.from_numpy(toks)})) == \
        float(out)


def test_lm_loss_f32_gradients_match_jax_grad(weights):
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg.vocab_size, SEQ, seed=7)
    jg = jax.jit(jax.grad(_jloss32(jcfg)))(jp, jnp.asarray(toks))
    leaves, td = tree_flatten(p)
    xs = [l.detach().requires_grad_(True) for l in leaves]
    loss = lm.lm_loss(tree_unflatten(td, xs), cfg,
                      {"tokens": torch.from_numpy(toks)},
                      dtype=torch.float32)
    gs = torch.autograd.grad(loss, xs)
    rel = [_rel(a, b.numpy()) for a, b in zip(jax.tree.leaves(jg), gs)]
    assert len(rel) == len(leaves) and max(rel) < GRAD_F32_REL, rel


def test_loss_recomputes_each_unit_repeat_once(weights, monkeypatch):
    """The loss checkpoints each unit repeat: under autograd, attention
    runs twice a layer (the forward and the backward's recompute), once
    without autograd; the gradients equal those without checkpoints."""
    jcfg, cfg, jp, p = weights
    calls = []
    real = blocks.flash_attention

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(blocks, "flash_attention", counting)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 32, seed=8))
    leaves, td = tree_flatten(p)
    xs = [l.detach().requires_grad_(True) for l in leaves]
    loss = lm.lm_loss(tree_unflatten(td, xs), cfg, {"tokens": toks},
                      dtype=torch.float32)
    g_remat = torch.autograd.grad(loss, xs)
    assert len(calls) == 2 * cfg.unit_repeats
    calls.clear()
    with torch.no_grad():
        lm.lm_loss(p, cfg, {"tokens": toks}, dtype=torch.float32)
    assert len(calls) == cfg.unit_repeats
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    logits, _ = lm.forward(tree_unflatten(td, xs), cfg, {"tokens": toks},
                           dtype=torch.float32)
    assert len(calls) == 2 * cfg.unit_repeats
    plain = softmax_xent_logits(logits, torch.from_numpy(
        _labels(toks.numpy())))
    for a, b in zip(g_remat, torch.autograd.grad(plain, xs)):
        assert torch.equal(a, b)


def test_model_grad_fn_bf16_matches_jax(weights):
    jcfg, cfg, jp, p = weights
    two = dict(num_layers=2, unit_repeats=2)
    jfn = JModelGradFn("qwen2-1.5b", overrides=two)
    fn = ModelGradFn("qwen2-1.5b", overrides=two, mesh_shape=(1, 1))
    assert fn.build_config() == cfg
    assert ModelGradFn("qwen2-1.5b", overrides=TINY_LM_OVERRIDES
                       ).build_config() == _tiny(get_config("qwen2-1.5b"))
    fn = pickle.loads(pickle.dumps(fn))
    assert fn._grad is None
    toks = _tokens(cfg.vocab_size, 64, seed=9, b=4)
    jg = jax.tree.leaves(jax.jit(jfn)(jp, jnp.asarray(toks)))
    g = tree_leaves(fn(p, torch.from_numpy(toks)))
    assert all(x.dtype == torch.float32 for x in g)
    rel = [_rel(a, b.numpy()) for a, b in zip(jg, g)]
    assert len(rel) == len(g) and max(rel) < GRAD_BF16_REL, rel
    with pytest.raises(NotImplementedError, match="A8"):
        ModelGradFn("qwen2-1.5b", mesh_shape=(2, 1))


# ---------------------------------------------------------------------------
# the pod-round step
# ---------------------------------------------------------------------------
def _state_from_jax(jstate):
    state = {k: lm_params_from_numpy(jax.tree.map(np.asarray, v), "cpu")
             for k, v in jstate.items() if k != "t"}
    state["t"] = torch.tensor(int(jstate["t"]), dtype=torch.int32)
    return state


def _assert_state_close(state, ref):
    """``ref``: theta, v, v0 as trees of numpy arrays (or JAX arrays)."""
    for a, b in zip(jax.tree.leaves(ref["theta"]),
                    tree_leaves(state["theta"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=THETA_TOL)
    for key in ("v", "v0"):
        rel = [_rel(a, b.numpy()) for a, b in
               zip(jax.tree.leaves(ref[key]), tree_leaves(state[key]))]
        assert max(rel) < MOMENTUM_REL, (key, rel)


@pytest.fixture(scope="module")
def step_setup():
    jcfg = dataclasses.replace(jget("qwen2-1.5b").reduced(), vocab_size=128)
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              vocab_size=128)
    jtask = jsyn.LMTask(vocab_size=128, seq_len=32, batch_size=4)
    task = synthetic.LMTask(vocab_size=128, seq_len=32, batch_size=4,
                            device="cpu")
    return jbuild(jcfg), build_model(cfg), jtask, task


def test_pod_round_step_one_pod_matches_jax_jit(step_setup):
    jmodel, model, jtask, task = step_setup
    mesh = make_host_mesh((1, 1, 1), ("pod", "data", "model"))
    with mesh:
        jstep, *_ = jsteps.build_train_step(jmodel, mesh,
                                            jsteps.TrainSettings(lr=1e-2))
        jstate = jax.jit(lambda k: jsteps.init_train_state(jmodel, k, 1))(
            jax.random.PRNGKey(0))
        state = _state_from_jax(jstate)
        jstep = jax.jit(jstep)
        step = steps.build_train_step(model, steps.TrainSettings(lr=1e-2))
        for i in range(3):
            jstate, jm = jstep(jstate, {"tokens": jtask.batch(0, i)})
            state, m = step(state, {"tokens": task.batch(0, i)})
            assert abs(float(m["loss"]) - float(jm["loss"])) < STEP_LOSS_TOL
            assert float(m["lr"]) == float(jm["lr"])
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=0.02)
    assert int(state["t"]) == int(jstate["t"]) == 3
    assert state["t"].dtype == torch.int32 and state["t"].dim() == 0
    _assert_state_close(state, jstate)


def test_pod_round_step_two_pods_matches_jax_grads_in_numpy(step_setup):
    """Two rounds of two pods against the algebra in numpy on the JAX
    model's per-pod loss and gradient at the bfloat16 look-ahead."""
    jmodel, model, jtask, task = step_setup
    lr, gamma = np.float32(1e-2), np.float32(0.9)
    jstate = jax.jit(lambda k: jsteps.init_train_state(jmodel, k, 2))(
        jax.random.PRNGKey(2))
    state = _state_from_jax(jstate)
    ref = {k: jax.tree.map(np.asarray, jstate[k])
           for k in ("theta", "v", "v0")}
    vg = jax.jit(jax.value_and_grad(jmodel.loss))
    step = steps.build_train_step(model, steps.TrainSettings(lr=1e-2))
    for i in range(2):
        toks = np.array(jtask.batch(0, i))
        hat16 = jax.tree.map(
            lambda t, s: jnp.asarray(t - lr * gamma * s, jnp.bfloat16),
            ref["theta"], ref["v0"])
        losses, grads = [], []
        for p in range(2):
            loss, g = vg(hat16, {"tokens": jnp.asarray(toks[2 * p:2 * p + 2])})
            losses.append(float(loss))
            grads.append(jax.tree.map(lambda x: np.asarray(x, np.float32), g))
        ref["v"] = jax.tree.map(
            lambda v, g0, g1: gamma * v + np.stack([g0, g1]),
            ref["v"], *grads)
        ref["v0"] = jax.tree.map(lambda v: np.sum(v, axis=0), ref["v"])
        ref["theta"] = jax.tree.map(lambda t, s: t - lr * s, ref["theta"],
                                    ref["v0"])
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        assert abs(float(m["loss"]) - np.mean(losses)) < STEP_LOSS_TOL
    _assert_state_close(state, ref)


def test_microbatches_two_match_one(step_setup):
    _, model, _, task = step_setup
    out = []
    for mb in (1, 2):
        state = steps.init_train_state(model, torch.Generator().manual_seed(
            3), 1, "cpu")
        step = steps.build_train_step(
            model, steps.TrainSettings(lr=1e-2, microbatches=mb))
        state, m = step(state, {"tokens": task.batch(0, 0)})
        out.append((float(m["loss"]), state))
    (l1, s1), (l2, s2) = out
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for a, b in zip(tree_leaves(s1["v0"]), tree_leaves(s2["v0"])):
        assert _rel(a.numpy(), b.numpy()) < MOMENTUM_REL


@pytest.mark.parametrize("pods", [2, 3])
def test_v0_is_the_sum_of_the_pod_momenta_bit_for_bit(step_setup, pods):
    _, model, _, _ = step_setup
    task = synthetic.LMTask(vocab_size=128, seq_len=16, batch_size=2 * pods,
                            device="cpu")
    state = steps.init_train_state(model, torch.Generator().manual_seed(4),
                                   pods, "cpu")
    step = steps.build_train_step(model, steps.TrainSettings(lr=1e-2))
    for i in range(2):
        state, m = step(state, {"tokens": task.batch(0, i)})
        assert np.isfinite(float(m["loss"]))
    for v, v0 in zip(tree_leaves(state["v"]), tree_leaves(state["v0"])):
        assert v.shape[0] == pods and torch.equal(torch.sum(v, dim=0), v0)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
TRAIN = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
         "--batch", "4", "--seq", "32", "--lr", "1e-2", "--log-every", "100"]


def test_train_cli_learns_and_resumes_bit_for_bit(tmp_path, capsys):
    first, last = train_mod.main(TRAIN + ["--steps", "30"])
    assert np.isfinite(last) and last < first
    full, part = tmp_path / "full", tmp_path / "part"
    run = TRAIN + ["--steps", "6", "--pods", "2", "--ckpt-every", "3",
                   "--ckpt"]
    train_mod.main(run + [str(full)])
    assert sorted(os.listdir(full)) == ["metrics.jsonl", "step_0000003.npz",
                                        "step_0000006.npz"]
    # resume from step 3 with the same flags (the schedule depends on
    # --steps through its milestone)
    part.mkdir()
    shutil.copy(full / "step_0000003.npz", part)
    train_mod.main(run + [str(part)])
    out = capsys.readouterr().out
    assert "resumed from" in out and "step     6  loss" in out
    like = steps.init_train_state(
        build_model(dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                                        vocab_size=512)),
        torch.Generator().manual_seed(0), 2, "cpu")
    a = load_pytree(f"{full}/step_0000006.npz", like)
    b = load_pytree(f"{part}/step_0000006.npz", like)
    assert int(a["t"]) == int(b["t"]) == 6
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    # a single-file checkpoint resumes too
    one = str(tmp_path / "state.npz")
    train_mod.main(TRAIN + ["--steps", "2", "--ckpt", one])
    train_mod.main(TRAIN + ["--steps", "3", "--ckpt", one])
    assert "resumed from" in capsys.readouterr().out


def test_train_cli_refuses_a_mesh():
    for extra in (["--mesh", "2x1"], ["--devices", "4"]):
        with pytest.raises(NotImplementedError, match="A8"):
            train_mod.main(TRAIN + ["--steps", "1"] + extra)


def test_cluster_lm_preset_deterministic_equals_engine(capsys):
    summary = cluster_mod.main([
        "--preset", "lm", "--device", "cpu", "--mode", "deterministic",
        "--workers", "4", "--grads", "24", "--batch", "4",
        "--eval-every", "12", "--compare-engine"])
    assert "BIT-EXACT" in capsys.readouterr().out
    assert summary["engine_max_param_diff"] == 0.0
    assert summary["updates"] == 24 and np.isfinite(summary["final_loss"])


def test_serve_cli_qwen2_reduced_on_cpu(capsys):
    stats = serve_mod.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                            "cpu", "--batch", "2", "--prompt-len", "8",
                            "--gen", "4"])
    assert stats["decode_tok_per_s"] > 0
    assert "qwen2-1.5b-reduced" in capsys.readouterr().out
