"""The port's serving layer (falcon-mamba) against the JAX package's.

* ``launch.serve.generate`` at float32 against a greedy loop over the
  JAX package's ``lm.prefill`` and ``lm.decode_step`` at float32, on the
  same weights: the tokens are equal, and the logits of each step agree
  to 1e-4 absolute (measured about 4e-6; ``tests/test_torch_lm.py``
  states why).
* The continuous-batching ``Engine`` against static generation, as
  ``tests/test_scheduler.py`` holds the JAX engine: one request equals a
  lone prefill + greedy decode; five requests through two slots all
  finish with ``max_new`` tokens; a request's tokens do not depend on
  what shares the batch; and a request's tokens equal the JAX greedy
  loop over its prompt left-padded with token 0 into its bucket (the
  pad tokens enter the state, as in the JAX engine).
* The CLI with ``--reduced --device cpu``.
* recurrentgemma-9b reduced with two unit repeats (8 layers, window 64,
  vocabulary 128), at float32 on the JAX package's weights: ``generate``
  over prompts longer than the window (the prefill's ring buffer rolls,
  decode writes past it) equals the JAX greedy loop token for token,
  logits to 1e-4; the Engine serves three requests through two slots,
  each slot at its own step and ring position (one slot wraps its
  capacity of 48), and every request's tokens equal both the JAX greedy
  loop and the port's lone prefill + decode over its left-padded
  bucket; the CLI with ``--arch recurrentgemma-9b --reduced``.
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

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import launches, reset_launches
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.models.attention import CacheSpec
from repro_torch.serve import Engine, Request

torch.set_num_threads(1)

F32_TOL = dict(rtol=0.0, atol=1e-4)
VOCAB = 128


def _cfgs():
    def two(c):
        return dataclasses.replace(c.reduced(), unit_repeats=2,
                                   num_layers=2, vocab_size=VOCAB)
    return two(jget("falcon-mamba-7b")), two(get_config("falcon-mamba-7b"))


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _cfgs()
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, build_model(cfg, torch.float32), p


def _jax_greedy(jcfg, jp, prompts, n, capacity):
    """The JAX package's prefill + greedy decode at float32: (tokens
    (B, n), logits of every step (B, n, V))."""
    spec = JSpec(capacity=capacity, window=None)
    pre = jax.jit(lambda q, t: jlm.prefill(q, jcfg, {"tokens": t}, spec,
                                           dtype=jnp.float32))
    dec = jax.jit(lambda q, t, c: jlm.decode_step(q, jcfg, t, c, spec,
                                                  dtype=jnp.float32))
    logits, cache = pre(jp, jnp.asarray(prompts, jnp.int32))
    steps = [logits[:, -1]]
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks = [tok]
    for _ in range(n - 1):
        logits, cache = dec(jp, tok, cache)
        steps.append(logits[:, -1])
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(tok)
    return (np.asarray(jnp.concatenate(toks, 1)),
            np.asarray(jnp.stack(steps, 1)))


def _static_generate(model, params, prompt, n, capacity=64):
    """The port's oracle: single-sequence prefill + greedy decode."""
    spec = CacheSpec(capacity=capacity, window=None)
    logits, cache = model.prefill(
        params, {"tokens": torch.as_tensor(prompt[None], dtype=torch.int32)},
        spec)
    tok = int(torch.argmax(logits[0, -1]))
    out = [tok]
    for _ in range(n - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([[tok]], dtype=torch.int32), cache, spec)
        tok = int(torch.argmax(logits[0, -1]))
        out.append(tok)
    return out


def test_generate_matches_jax_greedy_loop_f32(setup):
    jcfg, jp, model, p = setup
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, VOCAB, size=(3, 32)).astype(np.int32)
    gen = 6
    reset_launches()
    toks, stats = serve.generate(model, p, torch.from_numpy(prompts), gen)
    assert launches(["mamba_scan"]) == {"mamba_scan": 0}   # CPU: plain
    jtoks, jlogits = _jax_greedy(jcfg, jp, prompts, gen, 32 + gen)
    assert toks.dtype == torch.int32 and toks.shape == (3, gen)
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    assert set(stats) == {"prefill_s", "decode_s", "prefill_tok_per_s",
                          "decode_tok_per_s"}
    # the port's logits along the same tokens
    spec = CacheSpec(32 + gen, None)
    logits, cache = model.prefill(p, {"tokens": torch.from_numpy(prompts)},
                                  spec)
    steps = [logits[:, -1]]
    for j in range(gen - 1):
        logits, cache = model.decode_step(p, toks[:, j:j + 1], cache, spec)
        steps.append(logits[:, -1])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), jlogits,
                               **F32_TOL)


def test_engine_matches_static_path(setup):
    _, _, model, p = setup
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, VOCAB, size=16).astype(np.int32)
    eng = Engine(model, p, slots=2, capacity=64, prefill_buckets=(16,))
    eng.submit(Request(rid=0, prompt=prompt, max_new=6))
    done = eng.run()
    assert len(done) == 1
    assert done[0].output == _static_generate(model, p, prompt, 6)


def test_engine_many_requests_slot_reuse(setup):
    _, _, model, p = setup
    rng = np.random.default_rng(1)
    eng = Engine(model, p, slots=2, capacity=64, prefill_buckets=(16,))
    reqs = [Request(rid=i, prompt=rng.integers(0, VOCAB, size=8),
                    max_new=3 + (i % 3)) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 5                      # all served with 2 slots
    assert all(len(r.output) == r.max_new for r in done)
    s = eng.stats()
    assert s["requests"] == 5 and s["throughput_tok_s"] > 0
    assert s["tokens"] == sum(r.max_new for r in reqs)


def test_engine_interleaving_isolated(setup):
    """A request's output must not depend on what shares the batch."""
    _, _, model, p = setup
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, VOCAB, size=12)
    p2 = rng.integers(0, VOCAB, size=12)
    eng = Engine(model, p, slots=2, capacity=64, prefill_buckets=(16,))
    eng.submit(Request(rid=1, prompt=p1, max_new=5))
    eng.submit(Request(rid=2, prompt=p2, max_new=5))
    done = {r.rid: r.output for r in eng.run()}
    solo = Engine(model, p, slots=1, capacity=64, prefill_buckets=(16,))
    solo.submit(Request(rid=1, prompt=p1, max_new=5))
    assert done[1] == solo.run()[0].output


def test_engine_left_pads_into_its_bucket_like_jax(setup):
    """Prompts of 5 and 20 tokens go into buckets 16 and 32, left-padded
    with token 0; each request's tokens equal the JAX greedy loop over
    its padded bucket.  A retired slot takes the third request."""
    jcfg, jp, model, p = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, VOCAB, size=n).astype(np.int32)
               for n in (5, 20, 9)]
    eng = Engine(model, p, slots=2, capacity=64, prefill_buckets=(16, 32))
    for i, (pr, n) in enumerate(zip(prompts, (4, 7, 3))):
        eng.submit(Request(rid=i, prompt=pr, max_new=n))
    done = {r.rid: r.output for r in eng.run()}
    assert sorted(done) == [0, 1, 2]
    for i, (pr, n) in enumerate(zip(prompts, (4, 7, 3))):
        bucket = 16 if len(pr) <= 16 else 32
        padded = np.zeros((1, bucket), np.int32)
        padded[0, -len(pr):] = pr
        jtoks, _ = _jax_greedy(jcfg, jp, padded, n, 64)
        assert done[i] == jtoks[0].tolist()


def test_engine_retires_at_eos(setup):
    _, _, model, p = setup
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, VOCAB, size=16)
    ref = _static_generate(model, p, prompt, 8)
    eos = ref[3]
    eng = Engine(model, p, slots=1, capacity=64, prefill_buckets=(16,),
                 eos=eos)
    eng.submit(Request(rid=0, prompt=prompt, max_new=8))
    out = eng.run()[0].output
    # the first decoded token equal to eos ends it (the prefill's token
    # is not checked, as in the JAX engine)
    assert out == ref[:ref.index(eos, 1) + 1]


def test_cli_reduced_on_cpu(capsys):
    stats = serve.main(["--arch", "falcon-mamba-7b", "--reduced",
                        "--device", "cpu", "--batch", "2",
                        "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=falcon-mamba-7b-reduced" in out
    assert "prefill_tok_per_s" in out and "first sequences:" in out
    assert stats["prefill_tok_per_s"] > 0 and stats["decode_tok_per_s"] > 0


# ---------------------------------------------------------------------------
# recurrentgemma
# ---------------------------------------------------------------------------
RG_KERNELS = ["rglru_scan", "swa_attention"]


@pytest.fixture(scope="module")
def rg_setup():
    def two(c):
        return dataclasses.replace(c.reduced(), unit_repeats=2,
                                   num_layers=8, vocab_size=VOCAB)
    jcfg, cfg = two(jget("recurrentgemma-9b")), two(
        get_config("recurrentgemma-9b"))
    jp = jax.jit(lambda k: jlm.init_lm(k, jcfg))(jax.random.PRNGKey(1))
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, build_model(cfg, torch.float32), p


def test_generate_rg_matches_jax_greedy_loop_f32(rg_setup):
    jcfg, jp, model, p = rg_setup
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, VOCAB, size=(2, 80)).astype(np.int32)
    gen = 5
    reset_launches(RG_KERNELS)
    toks, _ = serve.generate(model, p, torch.from_numpy(prompts), gen)
    assert launches(RG_KERNELS) == {"rglru_scan": 0, "swa_attention": 0}
    jtoks, jlogits = _jax_greedy(jcfg, jp, prompts, gen, 80 + gen)
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    spec = CacheSpec(80 + gen, None)
    logits, cache = model.prefill(p, {"tokens": torch.from_numpy(prompts)},
                                  spec)
    assert cache["unit"][2]["k"].shape[2] == 64      # min(capacity, window)
    steps = [logits[:, -1]]
    for j in range(gen - 1):
        logits, cache = model.decode_step(p, toks[:, j:j + 1], cache, spec)
        steps.append(logits[:, -1])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), jlogits,
                               **F32_TOL)


def test_engine_rg_per_slot_positions_match_lone_path(rg_setup):
    """Prompts of 5, 30 and 12 tokens (buckets 16, 32, 16) through two
    slots of capacity 48: the second request decodes 30 tokens, so its
    slot's step runs to 62 and its ring buffer wraps while the other
    slot serves the first and then the third request at other steps."""
    jcfg, jp, model, p = rg_setup
    rng = np.random.default_rng(6)
    lens, news = (5, 30, 12), (4, 30, 6)
    prompts = [rng.integers(1, VOCAB, size=n).astype(np.int32) for n in lens]
    eng = Engine(model, p, slots=2, capacity=48, prefill_buckets=(16, 32))
    assert eng.cache["t"].shape == (2,)
    assert eng.cache["unit"][2]["pos"].shape == (2, 2, 48)
    for i, (pr, n) in enumerate(zip(prompts, news)):
        eng.submit(Request(rid=i, prompt=pr, max_new=n))
    slot_of = {}
    while eng.queue or eng.active_mask.any():
        eng.step()
        slot_of.update({r.rid: s for s, r in enumerate(eng.active) if r})
    done = {r.rid: r.output for r in eng.done}
    assert sorted(done) == [0, 1, 2]
    assert slot_of[0] == slot_of[2] != slot_of[1]     # slot 0 reused
    for i, (pr, n) in enumerate(zip(prompts, news)):
        bucket = 16 if len(pr) <= 16 else 32
        padded = np.zeros((bucket,), np.int32)
        padded[-len(pr):] = pr
        jtoks, _ = _jax_greedy(jcfg, jp, padded[None], n, 48)
        assert done[i] == jtoks[0].tolist()
        assert done[i] == _static_generate(model, p, padded, n, capacity=48)


def test_cli_recurrentgemma_reduced_on_cpu(capsys):
    stats = serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                        "--device", "cpu", "--batch", "2",
                        "--prompt-len", "70", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-9b-reduced" in out
    assert stats["prefill_tok_per_s"] > 0 and stats["decode_tok_per_s"] > 0
