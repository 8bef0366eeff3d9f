"""Four decoder-only families against the JAX package: chatglm3-6b (2-D
partial RoPE), granite-moe-3b-a800m (MoE, 40 experts top-8; reduced: 4
experts, all routed), llama4-scout-17b-a16e (MoE, top-1 with a shared
expert; reduced: 4 experts, tokens drop at capacity 1.25) and
qwen2-vl-7b (M-RoPE and an 8-position vision prefix when reduced).

Each reduced config with 2 unit repeats, on the JAX package's weights
(``convert.lm_params_from_numpy``), inputs from numpy seeds:

* ``make_batch`` equals the JAX batch leaf by leaf (tokens, the bf16
  prefix, the (3, B, S) positions).
* ``forward`` at float32: every MoE layer's routes equal JAX's (read off
  both routers, compared first); logits within 1e-4, aux within 1e-5
  relative.  ``lm_loss`` (the prefix's logits left out, 0.01 x aux)
  within 1e-5, and its gradients within 1e-4 relative L2 a leaf against
  ``jax.grad`` (the router's included).  bfloat16 forward within 0.15
  (C8) with the port's routes pinned to JAX's; the tokens that route to
  other experts at bfloat16 are counted (``-s`` prints them; measured 0-2
  of 80 a layer) and held under 5 %.
* Prefill and decode at float32 against JAX's (the prefill within 1e-4;
  a step from each side's own bfloat16 cache within 1e-3), and the
  port's prefill + one decode step against its forward over prompt +
  token, at bfloat16 within 0.15 (JAX ``tests/test_models_smoke.py``);
  the MoE configs at ``capacity_factor = E / k``, where nothing drops (a
  ragged forward groups otherwise than the prefill).  With the KV cache
  kept in float32 the float32 decode step equals forward to 1e-5: the
  serve path's gap is the bfloat16 cache's rounding alone (C6).
* ``generate`` at float32 equals a JAX greedy loop built as the JAX
  ``generate`` builds its batch (the zero prefix, the positions, a
  cache of prompt + gen), token for token; the Engine's tokens equal the
  JAX greedy loop over each request's left-padded bucket.
* The pod-round step: one pod against the JAX jitted step on a (1, 1, 1)
  mesh for granite-moe and qwen2-vl (C15: losses within 5e-3, theta
  within 5e-4, momenta within 5 % relative L2 a leaf); two pods against
  the JAX per-pod gradients at the bfloat16 look-ahead composed in numpy,
  qwen2-vl's positions split on their batch axis.
* The CLIs: ``launch.train`` and ``launch.serve`` for each family, and
  ``launch.cluster --preset lm --model granite-moe-3b-a800m --mode
  deterministic --compare-engine`` prints BIT-EXACT.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models.api import build_model as jbuild
from repro.models.attention import CacheSpec as JSpec
from repro.models.common import softmax_xent_logits as jxent

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, params_from_numpy
from repro_torch.core.types import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import cluster as cluster_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import blocks, lm, mlp
from repro_torch.models.api import build_model
from repro_torch.models.attention import CacheSpec
from repro_torch.serve import Engine, Request

torch.set_num_threads(1)

FAMILIES = ["chatglm3-6b", "granite-moe-3b-a800m", "llama4-scout-17b-a16e",
            "qwen2-vl-7b"]
F32_TOL = dict(rtol=0.0, atol=1e-4)
OWN_CACHE_TOL = dict(rtol=0.0, atol=1e-3)
BF16_TOL = dict(rtol=0.0, atol=0.15)
AUX_REL = 1e-5
LOSS_TOL = dict(rtol=0.0, atol=1e-5)
GRAD_F32_REL = 1e-4
STEP_LOSS_TOL = 5e-3
THETA_TOL = 5e-4
MOMENTUM_REL = 0.05
SEQ = 40                       # qwen2-vl: an 8-position prefix + 32 tokens
VOCAB = 128


def _two(c):
    return dataclasses.replace(c.reduced(), unit_repeats=2, num_layers=2,
                               vocab_size=VOCAB)


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    name = request.param
    jcfg, cfg = _two(jget(name)), _two(get_config(name))
    jp = jax.jit(lambda k: jlm.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _batches(cfg, seq=SEQ, b=2, seed=0):
    """(JAX batch, port batch) from the same numpy seed."""
    return (jbuild(cfg).make_batch(seq, b, seed=seed),
            build_model(cfg).make_batch(seq, b, seed=seed, device="cpu"))


def _extend(batch, tok):
    """The batch with ``tok`` (B,1) appended, positions one further."""
    cat = (lambda a, b: jnp.concatenate([a, b], -1)) \
        if isinstance(tok, jax.Array) else (lambda a, b: torch.cat([a, b], -1))
    out = dict(batch, tokens=cat(batch["tokens"], tok))
    if "positions" in batch:
        p3 = batch["positions"]
        out["positions"] = cat(p3, p3[:, :, -1:] + 1)
    return out


def _no_drop(cfg):
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_tok)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("seed", [0, 3])
def test_make_batch_equals_jax(name, seed):
    cfg = get_config(name).reduced()
    jb, b = _batches(cfg, seed=seed)
    assert set(jb) == set(b)
    assert b["tokens"].dtype == torch.int32
    for key in jb:
        assert np.array_equal(np.asarray(jb[key], np.float32),
                              b[key].float().numpy()), key
    if cfg.modality == "vision":
        assert b["embeds"].dtype == torch.bfloat16
        assert b["embeds"].shape == (2, cfg.modality_tokens, cfg.d_model)
        assert b["tokens"].shape == (2, SEQ - cfg.modality_tokens)
    if cfg.rope == "mrope":
        assert b["positions"].shape == (3, 2, SEQ)


def _record_routes(monkeypatch):
    """Lists that fill with each MoE layer's top_i, JAX's and the port's,
    in layer order."""
    jroutes, routes = [], []
    jreal, real = jmlp._router, mlp._router

    def jrec(*a, **kw):
        out = jreal(*a, **kw)
        jax.debug.callback(lambda t: jroutes.append(np.asarray(t)), out[1])
        return out

    def rec(*a, **kw):
        out = real(*a, **kw)
        routes.append(out[1].numpy())
        return out
    monkeypatch.setattr(jmlp, "_router", jrec)
    monkeypatch.setattr(mlp, "_router", rec)
    return jroutes, routes


def test_forward_matches_jax_f32(fam, monkeypatch):
    jcfg, cfg, jp, p = fam
    jb, b = _batches(cfg, seed=1)
    jroutes, routes = _record_routes(monkeypatch)
    jl, jaux = jax.jit(lambda q, bb: jlm.forward(q, jcfg, bb,
                                                 dtype=jnp.float32))(jp, jb)
    with torch.no_grad():
        logits, aux = lm.forward(p, cfg, b, dtype=torch.float32)
    assert len(routes) == len(jroutes) == (cfg.num_layers
                                           if cfg.num_experts else 0)
    for a, r in zip(routes, jroutes):        # the routes first
        assert np.array_equal(a, r)
    assert logits.shape == (2, SEQ, cfg.vocab_size)
    _close(logits, jl, F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_REL)
    if cfg.num_experts:
        assert float(aux) > 0


def _jloss32(jcfg):
    """JAX ``lm_loss`` at float32: the prefix's logits dropped, labels
    shifted, 0.01 x aux."""
    def loss(params, batch):
        logits, aux = jlm.forward(params, jcfg, batch, dtype=jnp.float32)
        toks = batch["tokens"]
        logits = logits[:, logits.shape[1] - toks.shape[1]:]
        labels = jnp.concatenate(
            [toks[:, 1:], jnp.full((toks.shape[0], 1), -1, jnp.int32)], 1)
        return jxent(logits, labels) + 0.01 * aux
    return loss


def test_loss_and_gradients_match_jax_f32(fam):
    jcfg, cfg, jp, p = fam
    jb, b = _batches(cfg, seed=2)
    jloss = _jloss32(jcfg)
    ref, jg = jax.jit(jax.value_and_grad(jloss))(jp, jb)
    leaves, td = tree_flatten(p)
    xs = [l.detach().requires_grad_(True) for l in leaves]
    loss = lm.lm_loss(tree_unflatten(td, xs), cfg, b, dtype=torch.float32)
    np.testing.assert_allclose(float(loss.detach()), float(ref), **LOSS_TOL)
    gs = torch.autograd.grad(loss, xs)
    rel = [_rel(a, g.numpy()) for a, g in zip(jax.tree.leaves(jg), gs)]
    assert len(rel) == len(leaves) and max(rel) < GRAD_F32_REL, rel
    if cfg.num_experts:
        router = tree_unflatten(td, list(gs))["unit"][0]["moe"]["router"]
        assert float(router.abs().max()) > 0


def test_bf16_forward_matches_jax_bf16(fam, monkeypatch):
    """bfloat16 forward against JAX's within 0.15 (C8).  XLA rounds the
    bf16 chains otherwise than PyTorch, so a token whose top-k choices
    sit within rounding of each other can route differently: their
    count is printed and held under 5 % of the tokens a layer, and the
    logits are compared with the port's routes pinned to JAX's (its own
    router probabilities, gathered at JAX's choices), since one flipped
    top-1 route moves the capacity fill of its whole group."""
    jcfg, cfg, jp, _ = fam
    jpb = jax.tree.map(lambda l: l.astype(jnp.bfloat16), jp)
    pb = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              torch.bfloat16)
    jb, b = _batches(cfg, seed=4)
    jroutes, routes = _record_routes(monkeypatch)
    jl, _ = jax.jit(jbuild(jcfg).forward)(jpb, jb)
    model = build_model(cfg)
    with torch.no_grad():
        logits, _ = model.forward(pb, b)
    assert logits.dtype == torch.bfloat16
    differ = [int(np.sum(np.any(np.sort(a, -1) != np.sort(r, -1), -1)))
              for a, r in zip(routes, jroutes)]
    print(f"{cfg.name}: bf16 tokens routed to other experts a layer: "
          f"{differ} of {2 * SEQ}")
    assert all(n <= 0.05 * 2 * SEQ for n in differ), differ
    if cfg.num_experts:
        pinned = iter(jroutes)

        def router(params, x, num_experts, top_k):
            top_i = torch.from_numpy(np.array(next(pinned))).long()
            logits = x.float() @ params["router"].float()
            probs = torch.softmax(logits, dim=-1)
            top_p = torch.gather(probs, -1, top_i)
            top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True),
                                            1e-9)
            return top_p, top_i, torch.zeros(())
        monkeypatch.setattr(mlp, "_router", router)
        with torch.no_grad():
            logits, _ = model.forward(pb, b)
    _close(logits, jl, BF16_TOL)


def test_prefill_and_decode_match_jax_f32(fam):
    jcfg, cfg, jp, p = fam
    jb, b = _batches(cfg, seed=5)
    cap = SEQ + 8
    jspec, spec = JSpec(cap, None), CacheSpec(cap, None)
    jl, jc = jax.jit(lambda q, bb: jlm.prefill(q, jcfg, bb, jspec,
                                               dtype=jnp.float32))(jp, jb)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    jl2, jc2 = jax.jit(lambda q, t, c: jlm.decode_step(
        q, jcfg, t, c, jspec, dtype=jnp.float32))(jp, jtok, jc)
    with torch.no_grad():
        logits, cache = lm.prefill(p, cfg, b, spec, dtype=torch.float32)
        tok = torch.from_numpy(np.array(jtok))
        l2, c2 = lm.decode_step(p, cfg, tok, cache, spec,
                                dtype=torch.float32)
        lj, _ = lm.decode_step(p, cfg, tok, params_from_numpy(
            jax.tree.map(np.asarray, jc), "cpu"), spec, dtype=torch.float32)
    _close(logits, jl, F32_TOL)
    _close(l2, jl2, OWN_CACHE_TOL)
    _close(lj, jl2, F32_TOL)
    assert int(c2["t"]) == int(jc2["t"]) == SEQ + 1
    np.testing.assert_array_equal(c2["unit"][0]["pos"].numpy(),
                                  np.asarray(jc2["unit"][0]["pos"]))


def test_prefill_then_decode_matches_forward_bf16(fam):
    """JAX ``test_prefill_then_decode_matches_forward`` on the port
    (bfloat16, 0.15), at a capacity where nothing drops for MoE."""
    _, cfg, _, p32 = fam
    cfg = _no_drop(cfg)
    model = build_model(cfg)
    p = lm_params_from_numpy(jax.tree.map(lambda t: t.numpy(), p32), "cpu",
                             torch.bfloat16)
    b = model.make_batch(SEQ, 2, seed=2, device="cpu")
    spec = CacheSpec(SEQ + 8, None)
    with torch.no_grad():
        last, cache = model.prefill(p, b, spec)
        nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
        step, _ = model.decode_step(p, nxt, cache, spec)
        full, _ = model.forward(p, _extend(b, nxt))
    assert torch.isfinite(step).all()
    _close(step[:, 0], full[:, -1].float().numpy(), BF16_TOL)


def test_decode_is_exact_with_a_float32_cache(fam, monkeypatch):
    """At float32 the whole gap between prefill + decode and forward is
    the KV cache's bfloat16 rounding (C6, C31): with the cache kept in
    float32 the decode step equals forward's last logits to 1e-5, vision
    prefix included."""
    _, cfg, _, p = fam
    cfg = _no_drop(cfg)
    real = blocks._cache_from_kv

    def f32_cache(k, v, spec):
        c = real(k, v, spec)
        pad = (k.shape[0], spec.capacity - k.shape[1]) + tuple(k.shape[2:])
        c["k"] = torch.cat([k, k.new_zeros(pad)], 1)
        c["v"] = torch.cat([v, v.new_zeros(pad)], 1)
        return c
    monkeypatch.setattr(blocks, "_cache_from_kv", f32_cache)
    model = build_model(cfg, torch.float32)
    b = model.make_batch(SEQ, 2, seed=8, device="cpu")
    spec = CacheSpec(SEQ + 1, None)
    with torch.no_grad():
        last, cache = model.prefill(p, b, spec)
        assert cache["unit"][0]["k"].dtype == torch.float32
        nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
        step, _ = model.decode_step(p, nxt, cache, spec)
        full, _ = model.forward(p, _extend(b, nxt))
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=0, atol=1e-5)


def _jax_generate_f32(jcfg, jp, prompts, n):
    """The JAX ``generate``'s batch and cache at float32: a greedy loop
    over ``lm.prefill`` / ``lm.decode_step``."""
    b, s = prompts.shape
    spec = JSpec(capacity=s + n, window=None)
    batch = {"tokens": jnp.asarray(prompts)}
    total = s
    if jcfg.modality == "vision":
        batch["embeds"] = jnp.zeros((b, jcfg.modality_tokens, jcfg.d_model),
                                    jnp.bfloat16)
        total += jcfg.modality_tokens
    if jcfg.rope == "mrope":
        batch["positions"] = jnp.broadcast_to(
            jnp.arange(total)[None, None], (3, b, total)).astype(jnp.int32)
    logits, cache = jax.jit(lambda q, bb: jlm.prefill(
        q, jcfg, bb, spec, dtype=jnp.float32))(jp, batch)
    dec = jax.jit(lambda q, t, c: jlm.decode_step(q, jcfg, t, c, spec,
                                                  dtype=jnp.float32))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks = [tok]
    for _ in range(n - 1):
        logits, cache = dec(jp, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(tok)
    return np.asarray(jnp.concatenate(toks, 1))


def test_generate_matches_jax_greedy_f32(fam):
    jcfg, cfg, jp, p = fam
    prompts = np.random.default_rng(6).integers(
        0, VOCAB, size=(2, 12)).astype(np.int32)
    gen = 5
    toks, stats = serve_mod.generate(build_model(cfg, torch.float32), p,
                                     torch.from_numpy(prompts), gen)
    assert toks.shape == (2, gen) and stats["decode_tok_per_s"] > 0
    np.testing.assert_array_equal(toks.numpy(),
                                  _jax_generate_f32(jcfg, jp, prompts, gen))


def test_engine_matches_jax_greedy_over_buckets(fam):
    """Three requests through two slots (one slot reused), f32: each
    request's tokens equal the JAX greedy loop over its prompt left-padded
    with token 0 into its bucket (the JAX engine's prefill: tokens only,
    default positions; each slot decodes alone)."""
    jcfg, cfg, jp, p = fam
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, VOCAB, size=n).astype(np.int32)
               for n in (5, 14, 9)]
    news = (4, 6, 3)
    eng = Engine(build_model(cfg, torch.float32), p, slots=2, capacity=32,
                 prefill_buckets=(8, 16))
    for i, (pr, n) in enumerate(zip(prompts, news)):
        eng.submit(Request(rid=i, prompt=pr, max_new=n))
    done = {r.rid: r.output for r in eng.run()}
    assert sorted(done) == [0, 1, 2]
    spec = JSpec(32, None)
    pre = jax.jit(lambda q, t: jlm.prefill(q, jcfg, {"tokens": t}, spec,
                                           dtype=jnp.float32))
    dec = jax.jit(lambda q, t, c: jlm.decode_step(q, jcfg, t, c, spec,
                                                  dtype=jnp.float32))
    for i, (pr, n) in enumerate(zip(prompts, news)):
        bucket = 8 if len(pr) <= 8 else 16
        padded = np.zeros((1, bucket), np.int32)
        padded[0, -len(pr):] = pr
        logits, cache = pre(jp, jnp.asarray(padded))
        out = [int(jnp.argmax(logits[0, -1]))]
        for _ in range(n - 1):
            logits, cache = dec(jp, jnp.asarray([[out[-1]]], jnp.int32),
                                cache)
            out.append(int(jnp.argmax(logits[0, -1])))
        assert done[i] == out, (i, done[i], out)


# ---------------------------------------------------------------------------
# the pod-round step
# ---------------------------------------------------------------------------
STEP_FAMILIES = ["granite-moe-3b-a800m", "qwen2-vl-7b"]


def _step_cfgs(name):
    return (dataclasses.replace(jget(name).reduced(), vocab_size=VOCAB),
            dataclasses.replace(get_config(name).reduced(),
                                vocab_size=VOCAB))


def _state_from_jax(jstate):
    state = {k: lm_params_from_numpy(jax.tree.map(np.asarray, v), "cpu")
             for k, v in jstate.items() if k != "t"}
    state["t"] = torch.tensor(int(jstate["t"]), dtype=torch.int32)
    return state


def _assert_state_close(state, ref):
    for a, b in zip(jax.tree.leaves(ref["theta"]),
                    tree_leaves(state["theta"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=THETA_TOL)
    for key in ("v", "v0"):
        rel = [_rel(a, b.numpy()) for a, b in
               zip(jax.tree.leaves(ref[key]), tree_leaves(state[key]))]
        assert max(rel) < MOMENTUM_REL, (key, rel)


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_pod_round_step_one_pod_matches_jax_jit(name):
    jcfg, cfg = _step_cfgs(name)
    jmodel, model = jbuild(jcfg), build_model(cfg)
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
            jb, b = _batches(cfg, seq=32, b=4, seed=10 + i)
            jstate, jm = jstep(jstate, jb)
            state, m = step(state, b)
            assert abs(float(m["loss"]) - float(jm["loss"])) < STEP_LOSS_TOL
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=0.02)
    assert int(state["t"]) == int(jstate["t"]) == 3
    _assert_state_close(state, jstate)


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_pod_round_step_two_pods_matches_jax_grads_in_numpy(name):
    """Two rounds of two pods against the algebra in numpy on the JAX
    model's per-pod loss and gradient at the bfloat16 look-ahead; the
    batch's rows (and the positions' axis 1) split between the pods."""
    jcfg, cfg = _step_cfgs(name)
    jmodel, model = jbuild(jcfg), build_model(cfg)
    lr, gamma = np.float32(1e-2), np.float32(0.9)
    jstate = jax.jit(lambda k: jsteps.init_train_state(jmodel, k, 2))(
        jax.random.PRNGKey(2))
    state = _state_from_jax(jstate)
    ref = {k: jax.tree.map(np.asarray, jstate[k])
           for k in ("theta", "v", "v0")}
    vg = jax.jit(jax.value_and_grad(jmodel.loss))
    step = steps.build_train_step(model, steps.TrainSettings(lr=1e-2))

    def rows(batch, lo, hi):
        return {k: (v[:, lo:hi] if k == "positions" else v[lo:hi])
                for k, v in batch.items()}
    for i in range(2):
        jb, b = _batches(cfg, seq=32, b=4, seed=20 + i)
        hat16 = jax.tree.map(
            lambda t, s: jnp.asarray(t - lr * gamma * s, jnp.bfloat16),
            ref["theta"], ref["v0"])
        losses, grads = [], []
        for pod in range(2):
            loss, g = vg(hat16, rows(jb, 2 * pod, 2 * pod + 2))
            losses.append(float(loss))
            grads.append(jax.tree.map(lambda x: np.asarray(x, np.float32), g))
        ref["v"] = jax.tree.map(
            lambda v, g0, g1: gamma * v + np.stack([g0, g1]),
            ref["v"], *grads)
        ref["v0"] = jax.tree.map(lambda v: np.sum(v, axis=0), ref["v"])
        ref["theta"] = jax.tree.map(lambda t, s: t - lr * s, ref["theta"],
                                    ref["v0"])
        state, m = step(state, b)
        assert abs(float(m["loss"]) - np.mean(losses)) < STEP_LOSS_TOL
    _assert_state_close(state, ref)
    for v, v0 in zip(tree_leaves(state["v"]), tree_leaves(state["v0"])):
        assert torch.equal(torch.sum(v, dim=0), v0)


def test_split_cuts_positions_on_their_batch_axis():
    b = build_model(get_config("qwen2-vl-7b").reduced()).make_batch(
        16, 4, device="cpu")
    parts = steps._split(b, 2)
    assert [p["tokens"].shape for p in parts] == [(2, 8)] * 2
    assert [p["embeds"].shape[0] for p in parts] == [2, 2]
    assert [tuple(p["positions"].shape) for p in parts] == [(3, 2, 16)] * 2
    assert torch.equal(parts[1]["positions"], b["positions"][:, 2:])
    assert torch.equal(parts[1]["embeds"], b["embeds"][2:])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_train_cli_runs_each_family(name, capsys):
    first, last = train_mod.main([
        "--arch", name, "--reduced", "--device", "cpu", "--batch", "4",
        "--seq", "16", "--steps", "3", "--pods", "2", "--lr", "1e-2",
        "--log-every", "100"])
    assert np.isfinite(first) and np.isfinite(last)
    assert f"arch: {name}-reduced" in capsys.readouterr().out


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_cli_runs_each_family(name, capsys):
    stats = serve_mod.main(["--arch", name, "--reduced", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "8", "--gen",
                            "3"])
    assert stats["decode_tok_per_s"] > 0
    assert f"arch={name}-reduced" in capsys.readouterr().out


def test_cluster_lm_preset_granite_moe_deterministic_equals_engine(capsys):
    summary = cluster_mod.main([
        "--preset", "lm", "--model", "granite-moe-3b-a800m", "--device",
        "cpu", "--mode", "deterministic", "--workers", "2", "--grads", "8",
        "--batch", "2", "--eval-every", "4", "--compare-engine"])
    assert "BIT-EXACT" in capsys.readouterr().out
    assert summary["engine_max_param_diff"] == 0.0
    assert summary["updates"] == 8 and np.isfinite(summary["final_loss"])
