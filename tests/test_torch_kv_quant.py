"""The port's int8 KV cache against the JAX package's.

* ``quantize_kv`` / ``dequantize_kv`` equal the eager JAX functions bit
  for bit (amax / 127 floored at 1e-8, round half to even, clip to
  +-127, int8; the same float32 divisions), on float32 and bfloat16
  inputs, and meet the JAX round-trip bound (amax / 254 an element).
* ``init_kv_cache(quant=True)`` has the JAX layout: int8 ``k``, ``v``,
  float32 ``k_scale``, ``v_scale`` (B, capacity, K), int32 ``pos``.
* Quantized prefill and decode of chatglm3-6b and qwen2-1.5b reduced
  with 2 unit repeats at float32, on the JAX package's weights: the
  prefill logits within 1e-4 (the int8 cache does not enter the
  prefill); the int8 caches equal JAX's but for codes one step apart
  where a float32 value sits within rounding of a half step (at most a
  few in a thousand), the scales within 1e-5 relative (the float32 K
  and V projections sum in another order; measured 1.5e-6); decode steps
  from the JAX cache carried across within 1e-4, from each side's own
  cache within 1e-3.  A decode step with one step per row (the Engine's
  ``t`` (B,), ``pos`` (B, capacity)) equals the scalar step to 1e-6.
* JAX ``tests/test_kv_quant.py``'s bounds on the port: greedy decoding
  from the int8 cache against the bfloat16 cache, each step's logits
  with cosine above 0.995, the greedy tokens agreeing on at least 3/4
  of the steps; the int8 cache under 0.7x the bfloat16 cache's bytes.
* The Engine on an int8 spec: the scales take their slot like every
  other leaf, and each request's tokens equal a lone int8 path's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.models.attention import CacheSpec as JSpec
from repro.models.attention import dequantize_kv as jdequant
from repro.models.attention import quantize_kv as jquant

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, params_from_numpy
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.models.attention import (CacheSpec, dequantize_kv,
                                          init_kv_cache, quantize_kv)

torch.set_num_threads(1)

F32_TOL = dict(rtol=0.0, atol=1e-4)
OWN_CACHE_TOL = dict(rtol=0.0, atol=1e-3)
SEQ = 24


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    x = np.random.default_rng(0).standard_normal((2, 8, 4, 64)).astype(
        np.float32) * np.float32(3.0)
    x[0, 0, 0] = 0.0                      # amax 0: the 1e-8 floor
    x[1, 2, 3, :4] = [0.5, -0.5, 1.5, 2.5]
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with jax.disable_jit():
        jq, js = jquant(jx)
        jr = jdequant(jq, js)
    q, s = quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(dequantize_kv(q, s).numpy(), np.asarray(jr))
    assert dequantize_kv(q, s, torch.bfloat16).dtype == torch.bfloat16


def test_quantize_roundtrip_error_bound():
    x = np.random.default_rng(1).standard_normal((2, 8, 4, 64)).astype(
        np.float32)
    q, s = quantize_kv(torch.from_numpy(x))
    xr = dequantize_kv(q, s).numpy()
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    assert np.all(np.abs(xr - x) <= amax / 254 + 1e-6)
    assert int(q.abs().max()) == 127


def test_init_kv_cache_quant_layout():
    c = init_kv_cache(2, 16, 3, 8, quant=True, device="cpu")
    assert c["k"].shape == c["v"].shape == (2, 16, 3, 8)
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert c["k_scale"].shape == c["v_scale"].shape == (2, 16, 3)
    assert c["k_scale"].dtype == torch.float32
    assert c["pos"].dtype == torch.int32 and int(c["pos"].max()) == -1


def _two(c):
    return dataclasses.replace(c.reduced(), unit_repeats=2, num_layers=2)


@pytest.fixture(scope="module", params=["chatglm3-6b", "qwen2-1.5b"])
def weights(request):
    name = request.param
    jcfg, cfg = _two(jget(name)), _two(get_config(name))
    jp = jax.jit(lambda k: jlm.init_lm(k, jcfg))(jax.random.PRNGKey(1))
    return jcfg, cfg, jp, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _tokens(vocab, s, seed, b=2):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, s)).astype(np.int32)


def test_quantized_prefill_and_decode_match_jax_f32(weights):
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg.vocab_size, SEQ + 2, seed=2)
    cap = SEQ + 8
    jspec, spec = JSpec(cap, None, True), CacheSpec(cap, None, True)
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
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **F32_TOL)
    for a, b in ((l2, jl2), (l3, jl3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   **OWN_CACHE_TOL)
    for c, jcc in ((cache, jc), (c3, jc3)):
        kv, jkv = c["unit"][0], jax.tree.map(np.asarray, jcc["unit"][0])
        assert set(kv) == set(jkv) == {"k", "v", "k_scale", "v_scale",
                                       "pos"}
        for key in ("k", "v"):
            assert kv[key].dtype == torch.int8
            diff = np.abs(kv[key].numpy().astype(np.int32)
                          - jkv[key].astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 5e-3, diff.mean()
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(kv[key].numpy(), jkv[key],
                                       rtol=1e-5, atol=0)
        np.testing.assert_array_equal(kv["pos"].numpy(), jkv["pos"])
    # from the JAX cache carried across, a step agrees to 1e-4
    lj, _ = lm.decode_step(p, cfg, t[:, SEQ:SEQ + 1], params_from_numpy(
        jax.tree.map(np.asarray, jc), "cpu"), spec, dtype=torch.float32)
    np.testing.assert_allclose(lj.numpy(), np.asarray(jl2), **F32_TOL)


def test_quantized_decode_per_row_steps_equal_scalar_step(weights):
    _, cfg, _, p = weights
    toks = torch.from_numpy(_tokens(cfg.vocab_size, SEQ + 1, seed=3))
    spec = CacheSpec(SEQ + 4, None, True)
    _, cache = lm.prefill(p, cfg, {"tokens": toks[:, :SEQ]}, spec,
                          dtype=torch.float32)
    ref, rc = lm.decode_step(p, cfg, toks[:, SEQ:], cache, spec,
                             dtype=torch.float32)
    rows = dict(cache, t=cache["t"].expand(2).clone(),
                unit=[dict(u, pos=u["pos"][:, None].expand(-1, 2, -1)
                           .clone()) for u in cache["unit"]])
    out, oc = lm.decode_step(p, cfg, toks[:, SEQ:], rows, spec,
                             dtype=torch.float32)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    for key in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(oc["unit"][0][key], rc["unit"][0][key])
    assert oc["t"].tolist() == [SEQ + 1] * 2


def _greedy(model, params, prompt, n, quant):
    spec = CacheSpec(capacity=48, window=None, quant=quant)
    logits, cache = model.prefill(params, {"tokens": prompt[None]}, spec)
    tok = int(torch.argmax(logits[0, -1]))
    out, trace = [tok], [logits[0, -1].float().numpy()]
    for _ in range(n - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([[tok]], dtype=torch.int32), cache, spec)
        tok = int(torch.argmax(logits[0, -1]))
        out.append(tok)
        trace.append(logits[0, -1].float().numpy())
    return out, np.stack(trace)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "chatglm3-6b"])
def test_quantized_decode_matches_bf16_cache(name):
    """JAX ``test_quantized_decode_matches_bf16_cache`` on the port, in
    its bfloat16 serve path with parameters drawn from a seed."""
    cfg = dataclasses.replace(get_config(name).reduced(), vocab_size=96)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, 96, size=16), dtype=torch.int32)
    out_f, logits_f = _greedy(model, params, prompt, 8, quant=False)
    out_q, logits_q = _greedy(model, params, prompt, 8, quant=True)
    for lf, lq in zip(logits_f, logits_q):
        cos = float(np.dot(lf, lq)
                    / (np.linalg.norm(lf) * np.linalg.norm(lq) + 1e-9))
        assert cos > 0.995, cos
    agree = sum(a == b for a, b in zip(out_f, out_q)) / len(out_f)
    assert agree >= 0.75, (out_f, out_q)


def test_quantized_cache_is_smaller():
    model = build_model(get_config("qwen2-1.5b").reduced())

    def nbytes(cache):
        from repro_torch.core.types import tree_leaves
        return sum(l.numel() * l.element_size() for l in tree_leaves(cache))
    cf = model.init_cache(2, CacheSpec(64, None, False), device="cpu")
    cq = model.init_cache(2, CacheSpec(64, None, True), device="cpu")
    assert cq["unit"][0]["k"].dtype == torch.int8
    assert nbytes(cq) < 0.7 * nbytes(cf)


def test_engine_serves_from_an_int8_cache():
    """An Engine whose spec quantizes (the JAX engine builds its spec
    without ``quant``; set here after construction) stacks ``k_scale`` and
    ``v_scale`` on the slot axis like every other leaf, and each request's
    tokens equal a lone int8 prefill + greedy decode of its left-padded
    bucket."""
    from repro_torch.serve import Engine, Request
    from repro_torch.serve.scheduler import _per_slot
    cfg = dataclasses.replace(get_config("chatglm3-6b").reduced(),
                              vocab_size=96)
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    eng = Engine(model, params, slots=2, capacity=32, prefill_buckets=(16,))
    eng.spec = CacheSpec(32, None, True)
    eng.cache = _per_slot(model.init_cache(2, eng.spec, device="cpu"), 2)
    kv = eng.cache["unit"][0]
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].shape == (1, 2, 32,
                                                                   2)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 96, size=n).astype(np.int32)
               for n in (6, 11, 9)]
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, max_new=4))
    done = {r.rid: r.output for r in eng.run()}
    for i, pr in enumerate(prompts):
        padded = np.zeros(16, np.int32)
        padded[-len(pr):] = pr
        out, _ = _greedy_spec(model, params, torch.from_numpy(padded), 4,
                              eng.spec)
        assert done[i] == out, (i, done[i], out)


def _greedy_spec(model, params, prompt, n, spec):
    logits, cache = model.prefill(params, {"tokens": prompt[None]}, spec)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([[out[-1]]], dtype=torch.int32), cache,
            spec)
        out.append(int(torch.argmax(logits[0, -1])))
    return out, cache
