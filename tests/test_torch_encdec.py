"""The enc-dec family (seamless-m4t-large-v2) against the JAX package.

seamless-m4t-large-v2 reduced with 2 decoder unit repeats and 2 encoder
layers (d_model 256, 4 heads, hd 64, vocab 128, frames up to 64), on the
JAX package's weights (``convert.lm_params_from_numpy``), inputs from
numpy seeds:

* The parameter tree (the ``encoder`` subtree, the ``lnx`` / ``xattn``
  leaves) has the JAX layout; ``make_batch`` equals the JAX batch leaf by
  leaf (the bf16 ``enc_embeds`` of min(max_encoder_len, S) frames).
* The encoder runs in bfloat16 whatever the model's type, as the JAX
  package runs it.  XLA and PyTorch round bfloat16 chains at other
  places, so the two encoders' outputs differ in the last bfloat16 bits
  (measured: 0.049 on outputs of magnitude 4; a float32 model's logits
  0.02 apart): the bfloat16 encoder is held to 0.15, the bf16 tolerance
  of C8.  The float32 comparisons hold the rest of the model to float32
  tolerances with that rounding taken out, two ways: the encoders kept
  in float32 on both sides (float32 copies of the port's and the JAX
  ``_encode``), and the JAX encoder's own bfloat16 output pinned
  into the port's decoder.  Then forward logits are within 1e-4, the
  loss within 1e-5 and every leaf's gradient (the encoder's included)
  within 1e-4 relative L2 of ``jax.grad``; the prefill within 1e-4, a
  decode step from the JAX cache within 1e-4 and from the port's own
  bfloat16 cache within 1e-3; the caches have the JAX layout (``self``,
  ``cross``, ``enc_out``).
* bfloat16 forward within 0.15 of JAX's, and the port's prefill + one
  decode step against its forward within 0.15.
* ``generate`` at float32 equals a JAX greedy loop over the JAX
  ``generate``'s batch (zero frames) token for token; the pod-round
  step against the JAX jitted step (C15's tolerances); ``_split`` cuts
  ``enc_embeds`` on its batch axis.
* The CLIs (``launch.serve`` and ``launch.train`` on the reduced config);
  the Engine and the lm preset's ``ModelGradFn`` refuse the config with
  a ValueError (the JAX ones pass no encoder input and fail on it);
  ``supports_shape`` refuses ``long_500k``.
* A reduced seamless train state saved by either package loads in the
  other bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload
from repro.checkpoint import save_pytree as jsave
from repro.configs import get_config as jget
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro.models.api import ModelGradFn as JModelGradFn
from repro.models.api import build_model as jbuild
from repro.models.attention import CacheSpec as JSpec
from repro.models.common import softmax_xent_logits as jxent

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.convert import lm_params_from_numpy, params_from_numpy
from repro_torch.core.types import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import cluster as cluster_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch.models.api import ModelGradFn, build_model, supports_shape
from repro_torch.models.attention import CacheSpec
from repro_torch.serve import Engine

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
F32_TOL = dict(rtol=0.0, atol=1e-4)
OWN_CACHE_TOL = dict(rtol=0.0, atol=1e-3)
BF16_TOL = dict(rtol=0.0, atol=0.15)
LOSS_TOL = dict(rtol=0.0, atol=1e-5)
GRAD_F32_REL = 1e-4
STEP_LOSS_TOL = 5e-3
THETA_TOL = 5e-4
MOMENTUM_REL = 0.05
SEQ = 40
VOCAB = 128


def _two(c):
    return dataclasses.replace(c.reduced(), unit_repeats=2, num_layers=2,
                               vocab_size=VOCAB)


@pytest.fixture(scope="module")
def enc():
    jcfg, cfg = _two(jget(ARCH)), _two(get_config(ARCH))
    jp = jax.jit(lambda k: jlm.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _jencode_f32(params, cfg, enc_embeds):
    """The JAX ``lm._encode`` with the frames kept in float32 (the JAX
    package casts them to bfloat16)."""
    x = enc_embeds.astype(jnp.float32)
    b, s, _ = x.shape
    ctx = {"positions": jlm._default_positions(cfg, b, s)}
    x, _, _ = jlm._unit_scan(params["encoder"]["unit"], x, cfg, ctx,
                             kinds=("attn_bidir",))
    return jlm.rms_norm(x, params["encoder"]["final_norm"])


def _encode_f32(params, cfg, enc_embeds):
    """The port's ``lm._encode`` with the frames kept in float32."""
    x = enc_embeds.float()
    ctx = {"positions": lm._default_positions(cfg, x.shape[0], x.shape[1],
                                              device=x.device)}
    x, _, _ = lm._unit_loop(params["encoder"]["unit"], x, cfg, ctx,
                            kinds=("attn_bidir",),
                            repeats=cfg.encoder_layers)
    return lm.rms_norm(x, params["encoder"]["final_norm"])


@pytest.fixture(params=["f32_encoders", "jax_bf16_encoder_pinned"])
def encoders(request, enc, monkeypatch):
    """Take the encoders' bfloat16 rounding out of a float32 comparison:
    both encoders in float32, or the JAX encoder's bfloat16 output (on
    the fixture's weights) fed to the port's decoder."""
    if request.param == "f32_encoders":
        monkeypatch.setattr(jlm, "_encode", _jencode_f32)
        monkeypatch.setattr(lm, "_encode", _encode_f32)
        return
    jcfg, _, jp, _ = enc
    jenc = jax.jit(lambda e: jlm._encode(jp, jcfg, e))

    def pinned(params, cfg, enc_embeds):
        out = jenc(jnp.asarray(enc_embeds.float().numpy(), jnp.bfloat16))
        return torch.from_numpy(np.asarray(out, np.float32)).to(
            torch.bfloat16)
    monkeypatch.setattr(lm, "_encode", pinned)


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


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


# ---------------------------------------------------------------------------
# parameters and batches
# ---------------------------------------------------------------------------
def test_param_tree_equals_jax_layout(enc):
    jcfg, cfg, jp, p = enc
    own = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    assert _layout(own) == _layout(p) == _layout(
        jax.tree.map(np.asarray, jp))
    assert set(own["encoder"]) == {"unit", "final_norm"}
    assert own["encoder"]["unit"][0]["attn"]["wq"].shape == (2, 256, 4, 64)
    assert "bq" not in own["unit"][0]["xattn"]


@pytest.mark.parametrize("seq,seed", [(SEQ, 0), (SEQ, 3), (80, 1)])
def test_make_batch_equals_jax(enc, seq, seed):
    cfg = enc[1]
    jb, b = _batches(cfg, seq=seq, seed=seed)
    assert set(jb) == set(b) == {"tokens", "enc_embeds"}
    for key in jb:
        assert np.array_equal(np.asarray(jb[key], np.float32),
                              b[key].float().numpy()), key
    assert b["enc_embeds"].dtype == torch.bfloat16
    assert b["enc_embeds"].shape == (2, min(seq, cfg.max_encoder_len),
                                     cfg.d_model)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------
def test_forward_matches_jax_f32(enc, encoders):
    jcfg, cfg, jp, p = enc
    jb, b = _batches(cfg, seed=1)
    jl, _ = jax.jit(lambda q, bb: jlm.forward(q, jcfg, bb,
                                              dtype=jnp.float32))(jp, jb)
    with torch.no_grad():
        logits, aux = lm.forward(p, cfg, b, dtype=torch.float32)
    assert logits.shape == (2, SEQ, VOCAB) and logits.dtype == torch.float32
    _close(logits, jl, F32_TOL)


def test_bf16_encoder_matches_jax_bf16_encoder(enc, capsys):
    """The shipped bfloat16 encoder against JAX's, and a float32 model's
    logits on top of each (the gap the float32 tests take out)."""
    jcfg, cfg, jp, p = enc
    jb, b = _batches(cfg, seed=1)
    je = jax.jit(lambda q, e: jlm._encode(q, jcfg, e))(jp, jb["enc_embeds"])
    jl, _ = jax.jit(lambda q, bb: jlm.forward(q, jcfg, bb,
                                              dtype=jnp.float32))(jp, jb)
    with torch.no_grad():
        e = lm._encode(p, cfg, b["enc_embeds"])
        logits, _ = lm.forward(p, cfg, b, dtype=torch.float32)
    assert e.dtype == torch.bfloat16 and e.shape == (2, SEQ, cfg.d_model)
    _close(e, je, BF16_TOL)
    _close(logits, jl, BF16_TOL)
    gap_e = np.abs(e.float().numpy() - np.asarray(je, np.float32)).max()
    gap_l = np.abs(logits.numpy() - np.asarray(jl)).max()
    with capsys.disabled():
        print(f"\nbf16 encoder vs JAX: output {gap_e}, f32 logits {gap_l}")


def test_bf16_forward_matches_jax_bf16(enc):
    jcfg, cfg, jp, _ = enc
    jpb = jax.tree.map(lambda l: l.astype(jnp.bfloat16), jp)
    pb = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              torch.bfloat16)
    jb, b = _batches(cfg, seed=4)
    jl, _ = jax.jit(jbuild(jcfg).forward)(jpb, jb)
    with torch.no_grad():
        logits, _ = build_model(cfg).forward(pb, b)
    assert logits.dtype == torch.bfloat16
    _close(logits, jl, BF16_TOL)


def test_loss_and_gradients_match_jax_f32(enc, monkeypatch):
    """Every leaf's gradient, the encoder's included, with both encoders
    in float32."""
    jcfg, cfg, jp, p = enc
    monkeypatch.setattr(jlm, "_encode", _jencode_f32)
    monkeypatch.setattr(lm, "_encode", _encode_f32)
    jb, b = _batches(cfg, seed=2)

    def jloss(params, batch):
        logits, _ = jlm.forward(params, jcfg, batch, dtype=jnp.float32)
        toks = batch["tokens"]
        labels = jnp.concatenate(
            [toks[:, 1:], jnp.full((toks.shape[0], 1), -1, jnp.int32)], 1)
        return jxent(logits, labels)
    ref, jg = jax.jit(jax.value_and_grad(jloss))(jp, jb)
    leaves, td = tree_flatten(p)
    xs = [l.detach().requires_grad_(True) for l in leaves]
    loss = lm.lm_loss(tree_unflatten(td, xs), cfg, b, dtype=torch.float32)
    np.testing.assert_allclose(float(loss.detach()), float(ref), **LOSS_TOL)
    gs = torch.autograd.grad(loss, xs)
    rel = [_rel(a, g.numpy()) for a, g in zip(jax.tree.leaves(jg), gs)]
    assert len(rel) == len(leaves) and max(rel) < GRAD_F32_REL, rel
    grads = tree_unflatten(td, list(gs))
    assert float(grads["encoder"]["unit"][0]["attn"]["wq"].abs().max()) > 0
    assert float(grads["unit"][0]["xattn"]["wk"].abs().max()) > 0


# ---------------------------------------------------------------------------
# prefill / decode / generate
# ---------------------------------------------------------------------------
def test_prefill_and_decode_match_jax_f32(enc, encoders):
    jcfg, cfg, jp, p = enc
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
    assert _layout(c2) == _layout(jax.tree.map(np.asarray, jc2))
    assert set(c2["unit"][0]) == {"self", "cross"}
    assert c2["unit"][0]["cross"]["k"].dtype == torch.bfloat16
    assert int(c2["t"]) == int(jc2["t"]) == SEQ + 1
    np.testing.assert_array_equal(c2["unit"][0]["self"]["pos"].numpy(),
                                  np.asarray(jc2["unit"][0]["self"]["pos"]))


def test_init_cache_equals_jax_layout(enc):
    jcfg, cfg, _, _ = enc
    jc = jbuild(jcfg).init_cache(3, JSpec(16, None))
    c = build_model(cfg).init_cache(3, CacheSpec(16, None), device="cpu")
    assert _layout(c) == _layout(jax.tree.map(np.asarray, jc))
    assert c["enc_out"].shape == (3, cfg.max_encoder_len, cfg.d_model)


def test_prefill_then_decode_matches_forward_bf16(enc):
    """JAX ``test_prefill_then_decode_matches_forward`` on the port
    (bfloat16, 0.15)."""
    _, cfg, _, p32 = enc
    model = build_model(cfg)
    p = lm_params_from_numpy(jax.tree.map(lambda t: t.numpy(), p32), "cpu",
                             torch.bfloat16)
    b = model.make_batch(SEQ, 2, seed=2, device="cpu")
    spec = CacheSpec(SEQ + 8, None)
    with torch.no_grad():
        last, cache = model.prefill(p, b, spec)
        nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
        step, _ = model.decode_step(p, nxt, cache, spec)
        full, _ = model.forward(p, dict(b, tokens=torch.cat(
            [b["tokens"], nxt], -1)))
    assert torch.isfinite(step).all()
    _close(step[:, 0], full[:, -1].float().numpy(), BF16_TOL)


def test_generate_matches_jax_greedy_f32(enc):
    """The JAX ``generate``'s batch (zero frames of the prompt's length)
    through a JAX greedy loop at float32, token for token."""
    jcfg, cfg, jp, p = enc
    prompts = np.random.default_rng(6).integers(
        0, VOCAB, size=(2, 12)).astype(np.int32)
    gen = 5
    toks, stats = serve_mod.generate(build_model(cfg, torch.float32), p,
                                     torch.from_numpy(prompts), gen)
    assert toks.shape == (2, gen) and stats["decode_tok_per_s"] > 0
    spec = JSpec(capacity=12 + gen, window=None)
    batch = {"tokens": jnp.asarray(prompts),
             "enc_embeds": jnp.zeros((2, 12, jcfg.d_model), jnp.bfloat16)}
    logits, cache = jax.jit(lambda q, bb: jlm.prefill(
        q, jcfg, bb, spec, dtype=jnp.float32))(jp, batch)
    dec = jax.jit(lambda q, t, c: jlm.decode_step(q, jcfg, t, c, spec,
                                                  dtype=jnp.float32))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    ref = [tok]
    for _ in range(gen - 1):
        logits, cache = dec(jp, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        ref.append(tok)
    np.testing.assert_array_equal(toks.numpy(),
                                  np.asarray(jnp.concatenate(ref, 1)))


# ---------------------------------------------------------------------------
# the pod-round step
# ---------------------------------------------------------------------------
def _state_from_jax(jstate):
    state = {k: lm_params_from_numpy(jax.tree.map(np.asarray, v), "cpu")
             for k, v in jstate.items() if k != "t"}
    state["t"] = torch.tensor(int(jstate["t"]), dtype=torch.int32)
    return state


def test_pod_round_step_one_pod_matches_jax_jit():
    jcfg = dataclasses.replace(jget(ARCH).reduced(), vocab_size=VOCAB)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), vocab_size=VOCAB)
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
    for a, b in zip(jax.tree.leaves(jstate["theta"]),
                    tree_leaves(state["theta"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=THETA_TOL)
    for key in ("v", "v0"):
        rel = [_rel(a, b.numpy()) for a, b in
               zip(jax.tree.leaves(jstate[key]), tree_leaves(state[key]))]
        assert max(rel) < MOMENTUM_REL, (key, rel)


def test_split_cuts_encoder_frames_on_their_batch_axis(enc):
    b = build_model(enc[1]).make_batch(16, 4, device="cpu")
    parts = steps._split(b, 2)
    assert [tuple(p["enc_embeds"].shape) for p in parts] == \
        [(2, 16, 256)] * 2
    assert torch.equal(parts[1]["enc_embeds"], b["enc_embeds"][2:])


# ---------------------------------------------------------------------------
# the CLIs, the refusals, the checkpoints
# ---------------------------------------------------------------------------
def test_train_cli_runs_seamless(capsys):
    first, last = train_mod.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4",
        "--seq", "16", "--steps", "6", "--pods", "2", "--lr", "1e-2",
        "--log-every", "100"])
    assert np.isfinite(first) and np.isfinite(last)
    assert f"arch: {ARCH}-reduced" in capsys.readouterr().out


def test_train_cli_encoder_frames_are_a_function_of_seed_and_step():
    cfg = get_config(ARCH).reduced()
    a = train_mod.encoder_frames(cfg, 2, 80, 0, 3, "cpu")
    assert a.shape == (2, 64, 256) and a.dtype == torch.bfloat16
    assert torch.equal(a, train_mod.encoder_frames(cfg, 2, 80, 0, 3, "cpu"))
    assert not torch.equal(a, train_mod.encoder_frames(cfg, 2, 80, 0, 4,
                                                       "cpu"))


def test_serve_cli_runs_seamless(capsys):
    stats = serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "8", "--gen",
                            "3"])
    assert stats["decode_tok_per_s"] > 0
    assert f"arch={ARCH}-reduced" in capsys.readouterr().out


def test_engine_and_lm_preset_refuse_the_encdec_config(enc):
    """The Engine's requests and the lm preset's token batches carry no
    encoder input: the port refuses the config where the JAX package
    fails at its first prefill or gradient (a KeyError, pinned here)."""
    _, cfg, _, p = enc
    with pytest.raises(ValueError, match=cfg.name):
        Engine(build_model(cfg, torch.float32), p, slots=2, capacity=16)
    with pytest.raises(ValueError, match=ARCH):
        ModelGradFn(ARCH)
    with pytest.raises(ValueError, match=ARCH):
        cluster_mod.main(["--preset", "lm", "--model", ARCH, "--device",
                          "cpu", "--mode", "deterministic", "--workers", "2",
                          "--grads", "2", "--batch", "2"])
    jfn = JModelGradFn(ARCH)
    jparams = jfn.init(jax.random.PRNGKey(0))
    with pytest.raises(KeyError, match="enc_embeds"):
        jfn(jparams, jnp.zeros((2, 8), jnp.int32))


def test_long_500k_stays_refused():
    ok, why = supports_shape(get_config(ARCH), INPUT_SHAPES["long_500k"])
    assert not ok and "enc-dec" in why


def test_train_states_cross_load_bit_for_bit(tmp_path):
    """A reduced seamless DANA state (2 pods: the encoder, xattn and lnx
    leaves) saved by either package loads in the other bit for bit."""
    jcfg = dataclasses.replace(jget(ARCH).reduced(), vocab_size=64)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), vocab_size=64)
    jstate = jax.jit(lambda k: jsteps.init_train_state(jbuild(jcfg), k, 2))(
        jax.random.PRNGKey(0))
    state = steps.init_train_state(build_model(cfg),
                                   torch.Generator().manual_seed(0), 2, "cpu")
    assert "encoder" in state["theta"] and "xattn" in state["v"]["unit"][0]
    jsave(str(tmp_path / "j.npz"), jstate)
    got = load_pytree(str(tmp_path / "j.npz"), state)
    for a, b in zip(jax.tree.leaves(jstate), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    save_pytree(str(tmp_path / "p.npz"), state)
    back = jload(str(tmp_path / "p.npz"), jstate)
    for a, b in zip(tree_leaves(state), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
