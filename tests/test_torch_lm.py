"""The port's LM stack (falcon-mamba) against the JAX package's.

* The ten configs equal the JAX package's field by field, reduced
  variants included.
* ``causal_conv1d`` equals the eager JAX version bit for bit (the same
  float32 products and sums in the same order); ``apply_mamba`` agrees
  with the JAX block on its chunked ``jnp`` path and on its Pallas path
  (interpret mode) to 2e-4, the tolerance of
  ``tests/test_kernel_dispatch.py`` (measured: about 2e-6).
* ``forward``, ``prefill`` and ``decode_step`` of falcon-mamba-7b
  reduced with 2 unit repeats, at float32, on the JAX package's weights
  (``convert.lm_params_from_numpy``): logits within 1e-4 absolute on
  logits of magnitude about 4.5 (measured: 2e-6 to 4e-6; the two
  libraries sum the matrix products in other orders).  The caches agree
  to the same tolerance and have the JAX layout.
* The default bfloat16 path against the JAX package's bfloat16 path:
  within 0.15 absolute, the JAX package's own bfloat16 tolerance for
  prefill + decode against forward (``tests/test_models_smoke.py``).
  Measured 0.0625; XLA fuses bfloat16 chains and rounds once where
  PyTorch rounds after each operation, and each side's bf16 logits are
  about 0.075 from its own float32 logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.models.api import build_model as jbuild
from repro.models.attention import CacheSpec as JSpec
from repro.models.common import kernel_dispatch
from repro.models.recurrent import apply_mamba as japply_mamba
from repro.models.recurrent import causal_conv1d as jconv
from repro.models.recurrent import init_mamba as jinit_mamba

from repro_torch.configs import (INPUT_SHAPES, REGISTRY, get_config,
                                 list_configs)
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import lm
from repro_torch.models.api import build_model, cache_spec_for
from repro_torch.models.attention import CacheSpec
from repro_torch.models.recurrent import (apply_mamba, apply_rglru,
                                          causal_conv1d, init_rglru,
                                          init_rglru_state, softplus)

torch.set_num_threads(1)

F32_TOL = dict(rtol=0.0, atol=1e-4)
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=0.0, atol=0.15)
SEQ = 64


def _cfgs():
    def two(c):
        return dataclasses.replace(c.reduced(), unit_repeats=2, num_layers=2)
    return two(jget("falcon-mamba-7b")), two(get_config("falcon-mamba-7b"))


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, s, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _layout(tree):
    """Structure, shapes and dtypes of a cache from either package."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    dt = str(tree.dtype).replace("torch.", "")
    return (tuple(tree.shape), dt)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(J_REGISTRY))
def test_config_equals_jax_field_by_field(name):
    port, ref = get_config(name), J_REGISTRY[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert dataclasses.asdict(get_config(name + "-reduced")) == \
        dataclasses.asdict(ref.reduced())
    assert (port.subquadratic, port.is_encdec, port.attn_kinds) == \
        (ref.subquadratic, ref.is_encdec, ref.attn_kinds)


def test_registry_and_shapes_equal_jax():
    assert list_configs() == list(J_REGISTRY)
    assert sorted(REGISTRY) == sorted(J_REGISTRY)
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


# ---------------------------------------------------------------------------
# the mamba block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_bit_equal_to_eager_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32)
    b = rng.standard_normal((32,)).astype(np.float32)
    st = (rng.standard_normal((2, 3, 32)).astype(np.float32)
          if with_state else None)
    y, new = causal_conv1d(*(None if a is None else torch.from_numpy(a)
                             for a in (x, w, b, st)))
    with jax.disable_jit():
        jy, jnew = jconv(*(None if a is None else jnp.asarray(a)
                           for a in (x, w, b, st)))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


def test_softplus_is_jax_logaddexp():
    """Across torch's softplus threshold (20) and far below zero: within
    one float32 ulp of ``jax.nn.softplus`` (the two libraries' exp and
    log1p differ by an ulp on some inputs; XLA flushes the subnormal
    result at -100 to zero)."""
    v = np.array([-100.0, -20.0, -1.0, 0.0, 1e-3, 1.0, 19.9, 20.0, 20.5,
                  35.0, 100.0], np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.nn.softplus(v)),
                               rtol=2.0 ** -23, atol=1e-38)


@pytest.mark.parametrize("kernel_path", [False, True],
                         ids=["jnp", "pallas-interpret"])
def test_apply_mamba_matches_jax(kernel_path):
    """One block, then its continuation from the returned state (a
    prefill and what follows it), against the JAX block on either of
    its paths."""
    jp = jinit_mamba(jax.random.PRNGKey(0), 64, 128, 16)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 32, 64)) * 0.1).astype(np.float32)
    with kernel_dispatch(kernel_path, interpret=True):
        jy1, jst = japply_mamba(jp, jnp.asarray(x[:, :16]))
        jy2, jst2 = japply_mamba(jp, jnp.asarray(x[:, 16:]), state=jst)
    y1, st = apply_mamba(p, torch.from_numpy(x[:, :16]))
    y2, st2 = apply_mamba(p, torch.from_numpy(x[:, 16:]), state=st)
    for a, b in ((y1, jy1), (y2, jy2), (st2["ssm"], jst2["ssm"]),
                 (st2["conv"], jst2["conv"])):
        _close(a, b, BLOCK_TOL)
    assert st2["ssm"].dtype == torch.float32
    assert st2["conv"].dtype == torch.float32


def test_rglru_raises_naming_its_roadmap_items():
    """The RG-LRU stubs that raised naming A7 and B6 are gone (the block
    is ported; its parity tests are in test_torch_recurrentgemma.py): the
    three functions run and keep the JAX package's shapes and types.
    What raised beside them runs too and keeps its shapes: the enc-dec
    family's non-causal and cross attention and packed segments (their
    parity tests are in test_torch_swa_attention.py), the RoPE variants
    and the MoE layer (test_torch_rope_variants.py, test_torch_moe.py)."""
    gen = torch.Generator().manual_seed(0)
    p = init_rglru(gen, 32, 64, 4, device="cpu")
    assert p["w_a"].shape == (4, 16, 16) and p["lam"].shape == (64,)
    st = init_rglru_state(2, 64, 4, device="cpu")
    assert st["conv"].shape == (2, 3, 64) and st["h"].dtype == torch.float32
    y, st2 = apply_rglru(p, torch.zeros((2, 5, 32)), state=st)
    assert y.shape == (2, 5, 32) and st2["h"].shape == (2, 64)
    from repro_torch.models.attention import cross_attention, flash_attention
    from repro_torch.models.common import rope_2d_partial, rope_mrope
    from repro_torch.models.mlp import apply_moe, init_moe
    q = torch.randn((1, 4, 2, 8), generator=gen)
    assert flash_attention(q, q, q, causal=False).shape == q.shape
    mem = torch.randn((1, 7, 2, 8), generator=gen)
    assert cross_attention(q, mem, mem).shape == q.shape
    out = flash_attention(q, q, q, segments=torch.ones((1, 4)))
    torch.testing.assert_close(out, flash_attention(q, q, q), rtol=0,
                               atol=0)
    pos = torch.zeros((1, 4), dtype=torch.int32)
    assert rope_2d_partial(q, pos).shape == q.shape
    assert rope_mrope(q, pos[None].expand(3, 1, 4), (1, 1, 2)).shape == \
        q.shape
    moe = init_moe(gen, 8, 16, 4, device="cpu")
    out, aux = apply_moe(moe, torch.zeros((1, 4, 8)), 4, 2)
    assert out.shape == (1, 4, 8) and float(aux) > 0


def test_unported_families_raise():
    """None of the ten configs raises any more: the enc-dec one
    (seamless-m4t-large-v2), which raised here naming A7(d)(iv), builds
    its encoder, makes its batch with the encoder's frames and inits
    both of its block kinds, with the JAX package's shapes (its parity
    tests are in test_torch_encdec.py); granite-moe and qwen2-vl, which
    raised here before they were ported, build and make their batches."""
    gen = torch.Generator().manual_seed(0)
    seamless = get_config("seamless-m4t-large-v2").reduced()
    p = lm.init_lm(gen, seamless, "cpu")
    assert p["encoder"]["unit"][0]["attn"]["wq"].shape == (2, 256, 4, 64)
    assert p["unit"][0]["xattn"]["wk"].shape == (1, 256, 4, 64)
    b = build_model(seamless).make_batch(8, 1, device="cpu")
    assert b["enc_embeds"].shape == (1, 8, 256)
    assert b["enc_embeds"].dtype == torch.bfloat16
    from repro_torch.models.blocks import init_block
    for kind, keys in (("attn_bidir", {"ln1", "attn", "ln2", "mlp"}),
                       ("attn_cross", {"ln1", "attn", "lnx", "xattn",
                                       "ln2", "mlp"})):
        assert set(init_block(gen, seamless, kind, "cpu")) == keys
    p = lm.init_lm(gen, get_config("granite-moe-3b-a800m").reduced(), "cpu")
    assert p["unit"][0]["moe"]["w_gate"].shape == (1, 4, 256, 512)
    b = build_model(get_config("qwen2-vl-7b").reduced()).make_batch(
        16, 1, device="cpu")
    assert b["embeds"].shape == (1, 8, 256)
    assert b["positions"].shape == (3, 1, 16)


# ---------------------------------------------------------------------------
# the LM at float32 on the JAX package's weights
# ---------------------------------------------------------------------------
def test_param_tree_equals_jax_layout(weights):
    jcfg, cfg, jp, p = weights
    gen = torch.Generator().manual_seed(0)
    own = lm.init_lm(gen, cfg, "cpu")
    assert _layout(own) == _layout(p) == _layout(
        jax.tree.map(np.asarray, jp))
    bf = lm.init_lm(gen, cfg, "cpu", torch.bfloat16)
    assert all(v[1] == "bfloat16" for v in jax.tree.leaves(
        _layout(bf), is_leaf=lambda v: isinstance(v, tuple)))


def test_forward_matches_jax_f32(weights):
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg, SEQ)
    jl, _ = jax.jit(lambda q, t: jlm.forward(
        q, jcfg, {"tokens": t}, dtype=jnp.float32))(jp, jnp.asarray(toks))
    logits, aux = lm.forward(p, cfg, {"tokens": torch.from_numpy(toks)},
                             dtype=torch.float32)
    assert logits.shape == (2, SEQ, cfg.vocab_size) and aux == 0.0
    _close(logits, jl, F32_TOL)


@pytest.mark.parametrize("kernel_path", [False, True],
                         ids=["jnp", "pallas-interpret"])
def test_prefill_and_decode_match_jax_f32(weights, kernel_path):
    """Prefill SEQ tokens, then two decode steps, on both packages: last
    logits, step logits and every cache leaf; and the port's decode
    against its own forward over prompt + tokens."""
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg, SEQ + 2, seed=3)
    jspec, spec = JSpec(SEQ + 8, None), CacheSpec(SEQ + 8, None)
    with kernel_dispatch(kernel_path, interpret=True):
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
    for a, b in ((logits, jl), (l2, jl2), (l3, jl3)):
        assert a.shape == (2, 1, cfg.vocab_size)
        _close(a, b, F32_TOL)
    assert _layout(cache) == _layout(jax.tree.map(np.asarray, jc))
    assert _layout(c3) == _layout(jax.tree.map(np.asarray, jc3))
    assert int(c3["t"]) == int(jc3["t"]) == SEQ + 2
    for key in ("conv", "ssm"):
        _close(c3["unit"][0][key], jc3["unit"][0][key], F32_TOL)
    full, _ = lm.forward(p, cfg, {"tokens": t}, dtype=torch.float32)
    torch.testing.assert_close(l3[:, 0], full[:, -1], **F32_TOL)
    torch.testing.assert_close(logits[:, 0], full[:, SEQ - 1], **F32_TOL)


def test_init_cache_equals_jax_layout(weights):
    jcfg, cfg, jp, p = weights
    for jdt, dt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        jc = jlm.init_cache(jcfg, 3, JSpec(16, None), dtype=jdt)
        c = lm.init_cache(cfg, 3, CacheSpec(16, None), dtype=dt,
                          device="cpu")
        assert _layout(c) == _layout(jax.tree.map(np.asarray, jc))
        assert all(float(l.abs().sum()) == 0 for l in (
            c["unit"][0]["conv"], c["unit"][0]["ssm"]))


def test_decode_from_scratch_matches_jax_f32(weights):
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg, 1, seed=4)
    jc = jlm.init_cache(jcfg, 2, JSpec(8, None), dtype=jnp.float32)
    jl, _ = jlm.decode_step(jp, jcfg, jnp.asarray(toks), jc,
                            JSpec(8, None), dtype=jnp.float32)
    c = lm.init_cache(cfg, 2, CacheSpec(8, None), dtype=torch.float32,
                      device="cpu")
    logits, _ = lm.decode_step(p, cfg, torch.from_numpy(toks), c,
                               CacheSpec(8, None), dtype=torch.float32)
    _close(logits, jl, F32_TOL)


# ---------------------------------------------------------------------------
# the default bfloat16 path, the model API and the serve steps
# ---------------------------------------------------------------------------
def test_bf16_default_path_matches_jax_bf16(weights):
    jcfg, cfg, jp, _ = weights
    jpb = jax.tree.map(lambda l: l.astype(jnp.bfloat16)
                       if l.dtype == jnp.float32 else l, jp)
    pb = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              torch.bfloat16)
    toks = _tokens(cfg, SEQ, seed=5)
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
    assert _layout(c) == _layout(jax.tree.map(np.asarray, jc))
    assert c["unit"][0]["conv"].dtype == torch.bfloat16
    assert c["unit"][0]["ssm"].dtype == torch.float32
    l2, _ = model.decode_step(pb, torch.from_numpy(toks[:, -1:]), c, spec)
    _close(l2[:, 0], logits[:, -1].float().numpy(), BF16_TOL)


def test_make_batch_draws_the_jax_stream():
    jcfg, cfg = _cfgs()
    jb = jbuild(jcfg).make_batch(24, 3, seed=7)
    b = build_model(cfg).make_batch(24, 3, seed=7, device="cpu")
    assert b["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))


def test_serve_steps_are_the_model_functions_with_the_shape_spec(weights):
    jcfg, cfg, jp, p = weights
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"], seq_len=SEQ + 4)
    spec = cache_spec_for(cfg, shape)
    assert spec == CacheSpec(SEQ + 4, None)
    assert cache_spec_for(cfg, INPUT_SHAPES["long_500k"]) == \
        CacheSpec(1, None)
    model = build_model(cfg, torch.float32)
    toks = torch.from_numpy(_tokens(cfg, SEQ + 1, seed=6))
    logits, cache = build_prefill_step(model, shape)(
        p, {"tokens": toks[:, :SEQ]})
    l2, _ = build_decode_step(model, shape)(p, toks[:, SEQ:], cache)
    r1, rc = model.prefill(p, {"tokens": toks[:, :SEQ]}, spec)
    r2, _ = model.decode_step(p, toks[:, SEQ:], rc, spec)
    torch.testing.assert_close(logits, r1, rtol=0, atol=0)
    torch.testing.assert_close(l2, r2, rtol=0, atol=0)
