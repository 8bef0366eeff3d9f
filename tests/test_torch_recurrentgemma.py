"""The port's recurrentgemma stack against the JAX package's.

On recurrentgemma-9b-reduced (5 layers: 2 + 1 x (rec, rec, attn_local),
d_model 256, 4 heads, 1 kv head, head_dim 64, window 64; the CLI's
``--reduced``), on the JAX package's weights (``convert``), inputs from
numpy seeds (``tests/test_torch_serve.py`` runs two unit repeats):

* ``_rope_freqs`` equals the JAX frequencies bit for bit (a float32
  arange over d2, a float32 power); ``rope_1d`` agrees to 2e-6 (cos and
  sin of the same float32 angles, one ulp apart at most).
* ``jax.nn.gelu``'s default is the tanh approximation, which the RG-LRU
  gate uses: ``F.gelu(approximate="tanh")`` agrees to 1e-6, the erf form
  does not.
* ``apply_mlp`` to 1e-5; ``apply_rglru`` and its continuation from the
  returned state against the JAX block on its ``jnp`` path and on its
  Pallas path (interpret mode) to 2e-4, the block tolerance of
  ``tests/test_kernel_dispatch.py``; the ``rec`` and ``attn_local``
  blocks (apply, prefill with its cache, one decode step from the JAX
  cache carried across) to 2e-4.
* ``_cache_from_kv`` equals the JAX ring buffer leaf by leaf, bit for
  bit, in both branches (S < capacity: padding; S >= capacity: the roll
  by tail % capacity); K and V are bfloat16 whatever the model's type.
* ``forward``, ``prefill`` and ``decode_step`` at float32 with a prompt
  of 90 tokens (past the window of 64) and three decode steps (ring
  slots 26-28): logits within 1e-4 absolute on logits of magnitude about
  4.5, the tolerance of ``tests/test_torch_lm.py``; decode steps also
  from the JAX cache carried across.  Each side decodes from its own
  bfloat16 KV cache, where one-ulp roundings differ (cache K and V agree
  to one bfloat16 step, or 1e-5 near zero; conv and h states to 1e-4).
* The default bfloat16 path against the JAX package's within 0.15
  absolute (its own bfloat16 tolerance for prefill + decode; measured
  0.13).  XLA's bfloat16 sigmoid and gelu round differently from
  PyTorch's on most inputs, and each side's bfloat16 logits are 0.15 to
  0.18 from its own float32 logits here; with two unit repeats (8
  layers) both drift to about 0.2 and the two bfloat16 paths differ by
  up to 0.19.
* A decode step with one step per row (the Engine's ``t`` (B,) and
  ``pos`` (B, capacity)) equals each row decoded alone at its step, to
  1e-4 (a batch of two rows sums the matrix products in another order
  than one row; measured 2e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.api import build_model as jbuild
from repro.models.api import cache_spec_for as jcache_spec_for
from repro.models.attention import CacheSpec as JSpec
from repro.models.common import _rope_freqs as jfreqs
from repro.models.common import kernel_dispatch
from repro.models.common import rope_1d as jrope
from repro.models.mlp import apply_mlp as japply_mlp
from repro.models.mlp import init_mlp as jinit_mlp
from repro.models.recurrent import apply_rglru as japply_rglru
from repro.models.recurrent import init_rglru as jinit_rglru

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.convert import lm_params_from_numpy, params_from_numpy
from repro_torch.models import blocks, lm
from repro_torch.models.api import build_model, cache_spec_for
from repro_torch.models.attention import CacheSpec
from repro_torch.models.common import _rope_freqs, rope_1d
from repro_torch.models.mlp import apply_mlp
from repro_torch.models.recurrent import apply_rglru

torch.set_num_threads(1)

F32_TOL = dict(rtol=0.0, atol=1e-4)
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=0.0, atol=0.15)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-5)     # one bfloat16 step
SEQ = 90                                        # past the window of 64


def _cfgs():
    return (jget("recurrentgemma-9b").reduced(),
            get_config("recurrentgemma-9b").reduced())


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jp = jax.jit(lambda k: jlm.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), _np(ref), **tol)


def _tokens(cfg, s, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _positions(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


# ---------------------------------------------------------------------------
# RoPE, gelu, the MLP
# ---------------------------------------------------------------------------
def test_rope_1d_matches_jax():
    assert torch.equal(_rope_freqs(64), torch.from_numpy(
        np.array(jfreqs(64))))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 48, 4, 64)).astype(np.float32)
    pos = _positions(2, 48) + np.int32(20)
    out = rope_1d(torch.from_numpy(x), torch.from_numpy(pos))
    _close(out, jrope(jnp.asarray(x), jnp.asarray(pos)),
           dict(rtol=0, atol=2e-6))
    xb = torch.from_numpy(x).bfloat16()
    assert rope_1d(xb, torch.from_numpy(pos)).dtype == torch.bfloat16


def test_gelu_default_is_the_tanh_approximation():
    v = np.linspace(-6, 6, 1001).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(v)))
    tanh = F.gelu(torch.from_numpy(v), approximate="tanh").numpy()
    np.testing.assert_allclose(tanh, ref, rtol=0, atol=1e-6)
    erf = F.gelu(torch.from_numpy(v)).numpy()
    assert np.abs(erf - ref).max() > 1e-4


def test_apply_mlp_matches_jax():
    jp = jinit_mlp(jax.random.PRNGKey(1), 64, 128)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = (np.random.default_rng(1).standard_normal((2, 7, 64)) * 0.5
         ).astype(np.float32)
    _close(apply_mlp(p, torch.from_numpy(x)),
           japply_mlp(jp, jnp.asarray(x)), dict(rtol=1e-5, atol=1e-5))


# ---------------------------------------------------------------------------
# the RG-LRU and the blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel_path", [False, True],
                         ids=["jnp", "pallas-interpret"])
def test_apply_rglru_matches_jax_with_state_chaining(kernel_path):
    jp = jinit_rglru(jax.random.PRNGKey(2), 64, 128, 4)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = (np.random.default_rng(2).standard_normal((2, 32, 64)) * 0.5
         ).astype(np.float32)
    with kernel_dispatch(kernel_path, interpret=True):
        jy1, jst = jax.jit(japply_rglru)(jp, jnp.asarray(x[:, :16]))
        jy2, jst2 = jax.jit(japply_rglru)(jp, jnp.asarray(x[:, 16:]),
                                          state=jst)
    y1, st = apply_rglru(p, torch.from_numpy(x[:, :16]))
    y2, st2 = apply_rglru(p, torch.from_numpy(x[:, 16:]), state=st)
    for a, b in ((y1, jy1), (y2, jy2), (st2["h"], jst2["h"]),
                 (st2["conv"], jst2["conv"])):
        _close(a, b, BLOCK_TOL)
    assert st2["h"].dtype == torch.float32


@pytest.mark.parametrize("kind", ["rec", "attn_local"])
def test_block_apply_prefill_and_decode_match_jax(weights, kind):
    """Layer 0 of the unit's block of ``kind``: apply over 80 positions
    (past the window), prefill with its cache, one decode step from the
    JAX cache carried across."""
    jcfg, cfg, jp, p = weights
    j = cfg.pattern_unit.index(kind)
    jbp = jax.tree.map(lambda l: l[0], jp["unit"][j])
    bp = lm._layer(p["unit"][j], 0)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 80, cfg.d_model)) * 0.5).astype(np.float32)
    pos = _positions(2, 80)
    jy, _, _ = jax.jit(lambda q, xx, pp: jblocks.apply_block(
        q, xx, kind, jcfg, {"positions": pp}))(jbp, jnp.asarray(x),
                                               jnp.asarray(pos))
    y, _, _ = blocks.apply_block(bp, torch.from_numpy(x), kind, cfg,
                                 {"positions": torch.from_numpy(pos)})
    _close(y, jy, BLOCK_TOL)
    jspec, spec = JSpec(96, None), CacheSpec(96, None)
    jy, _, jc = jax.jit(lambda q, xx, pp: jblocks.prefill_block(
        q, xx, kind, jcfg, {"positions": pp, "spec": jspec}))(
        jbp, jnp.asarray(x), jnp.asarray(pos))
    y, _, c = blocks.prefill_block(bp, torch.from_numpy(x), kind, cfg,
                                   {"positions": torch.from_numpy(pos),
                                    "spec": spec})
    _close(y, jy, BLOCK_TOL)
    jcn = jax.tree.map(np.asarray, jc)
    assert _layout(c) == _layout(jcn)
    for key in c:
        tol = BF16_ULP if key in ("k", "v") else BLOCK_TOL
        _close(c[key], jcn[key], tol)
    x1 = (rng.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(np.float32)
    t = 80
    jy1, jc1 = jax.jit(lambda q, xx, cc: jblocks.decode_block(
        q, xx, kind, jcfg, cc,
        {"t": jnp.asarray(t, jnp.int32), "spec": jspec,
         "positions": jnp.full((2, 1), t, jnp.int32)}))(
        jbp, jnp.asarray(x1), jc)
    y1, c1 = blocks.decode_block(
        bp, torch.from_numpy(x1), kind, cfg, params_from_numpy(jcn, "cpu"),
        {"t": torch.tensor(t, dtype=torch.int32), "spec": spec,
         "positions": torch.full((2, 1), t, dtype=torch.int32)})
    _close(y1, jy1, BLOCK_TOL)
    for key, val in jax.tree.map(np.asarray, jc1).items():
        _close(c1[key], val, BF16_ULP if key in ("k", "v") else BLOCK_TOL)


@pytest.mark.parametrize("s,cap", [(20, 32), (32, 32), (90, 64), (200, 64)])
def test_cache_from_kv_equals_jax_ring_buffer(s, cap):
    rng = np.random.default_rng(s)
    k = rng.standard_normal((2, s, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 1, 16)).astype(np.float32)
    jc = jax.tree.map(np.asarray, jblocks._cache_from_kv(
        jnp.asarray(k), jnp.asarray(v), JSpec(cap, 64)))
    c = blocks._cache_from_kv(torch.from_numpy(k), torch.from_numpy(v),
                              CacheSpec(cap, 64))
    assert _layout(c) == _layout(jc)
    assert c["k"].dtype == c["v"].dtype == torch.bfloat16
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(_np(c[key]), _np(jc[key]))
    # slot = pos % capacity
    valid = c["pos"] >= 0
    assert torch.equal(torch.nonzero(valid)[:, 0],
                       c["pos"][valid].long() % cap)


def test_init_cache_equals_jax_layout(weights):
    jcfg, cfg, _, _ = weights
    for jdt, dt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        for capacity in (16, 200):
            jc = jax.tree.map(np.asarray, jlm.init_cache(
                jcfg, 3, JSpec(capacity, None), dtype=jdt))
            c = lm.init_cache(cfg, 3, CacheSpec(capacity, None), dtype=dt,
                              device="cpu")
            assert _layout(c) == _layout(jc)
            np.testing.assert_array_equal(_np(c["unit"][2]["pos"]),
                                          _np(jc["unit"][2]["pos"]))
            assert c["unit"][2]["k"].shape[2] == min(capacity, 64)


# ---------------------------------------------------------------------------
# the LM at float32 on the JAX package's weights
# ---------------------------------------------------------------------------
def test_param_tree_equals_jax_layout(weights):
    jcfg, cfg, jp, p = weights
    own = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    assert _layout(own) == _layout(p) == _layout(
        jax.tree.map(np.asarray, jp))


def test_forward_prefill_and_decode_match_jax_f32(weights):
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg, SEQ + 3, seed=4)
    jl, _ = jax.jit(lambda q, t: jlm.forward(
        q, jcfg, {"tokens": t}, dtype=jnp.float32))(jp, jnp.asarray(toks))
    t = torch.from_numpy(toks)
    full, aux = lm.forward(p, cfg, {"tokens": t}, dtype=torch.float32)
    assert full.shape == (2, SEQ + 3, cfg.vocab_size) and aux == 0.0
    _close(full, jl, F32_TOL)

    jspec, spec = JSpec(SEQ + 8, None), CacheSpec(SEQ + 8, None)
    jl1, jc = jax.jit(lambda q, x: jlm.prefill(
        q, jcfg, {"tokens": x}, jspec, dtype=jnp.float32))(
        jp, jnp.asarray(toks[:, :SEQ]))
    logits, c = lm.prefill(p, cfg, {"tokens": t[:, :SEQ]}, spec,
                           dtype=torch.float32)
    _close(logits, jl1, F32_TOL)
    jstep = jax.jit(lambda q, x, cc: jlm.decode_step(
        q, jcfg, x, cc, jspec, dtype=jnp.float32))
    for j in range(3):
        tok = toks[:, SEQ + j:SEQ + j + 1]
        jcn = jax.tree.map(np.asarray, jc)
        assert _layout(c) == _layout(jcn)
        for key in ("k", "v"):
            _close(c["unit"][2][key], jcn["unit"][2][key], BF16_ULP)
        np.testing.assert_array_equal(_np(c["unit"][2]["pos"]),
                                      _np(jcn["unit"][2]["pos"]))
        for key in ("conv", "h"):
            _close(c["unit"][0][key], jcn["unit"][0][key], F32_TOL)
        carried, _ = lm.decode_step(p, cfg, torch.from_numpy(tok),
                                    params_from_numpy(jcn, "cpu"), spec,
                                    dtype=torch.float32)
        jl1, jc = jstep(jp, jnp.asarray(tok), jc)
        logits, c = lm.decode_step(p, cfg, torch.from_numpy(tok), c, spec,
                                   dtype=torch.float32)
        _close(carried, jl1, F32_TOL)
        _close(logits, jl1, F32_TOL)
    assert int(c["t"]) == int(jc["t"]) == SEQ + 3
    # ring slots 26, 27, 28 now hold positions 90, 91, 92
    assert c["unit"][2]["pos"][0, 26:29].tolist() == [90, 91, 92]


def test_decode_from_scratch_matches_jax_f32(weights):
    jcfg, cfg, jp, p = weights
    toks = _tokens(cfg, 2, seed=5)
    jspec, spec = JSpec(8, None), CacheSpec(8, None)
    jc = jlm.init_cache(jcfg, 2, jspec, dtype=jnp.float32)
    c = lm.init_cache(cfg, 2, spec, dtype=torch.float32, device="cpu")
    jstep = jax.jit(lambda q, x, cc: jlm.decode_step(
        q, jcfg, x, cc, jspec, dtype=jnp.float32))
    for j in range(2):
        jl, jc = jstep(jp, jnp.asarray(toks[:, j:j + 1]), jc)
        logits, c = lm.decode_step(p, cfg, torch.from_numpy(
            toks[:, j:j + 1]), c, spec, dtype=torch.float32)
        _close(logits, jl, F32_TOL)
    assert c["unit"][2]["k"].dtype == torch.float32   # init_cache's type


def test_per_row_steps_equal_each_row_alone(weights):
    """Two sequences prefilled apart (70 and 20 tokens, so one has
    wrapped its ring buffer), joined into one cache with ``t`` (2,) and
    per-row ``pos``: one batched decode step equals each row's own."""
    _, cfg, _, p = weights
    spec = CacheSpec(64, None)
    rows = []
    for n, seed in ((70, 6), (20, 7)):
        toks = torch.from_numpy(_tokens(cfg, n + 1, seed=seed, b=1))
        _, c = lm.prefill(p, cfg, {"tokens": toks[:, :n]}, spec,
                          dtype=torch.float32)
        alone, _ = lm.decode_step(p, cfg, toks[:, n:], c, spec,
                                  dtype=torch.float32)
        rows.append((toks[:, n:], c, alone))

    (t0, c0, l0), (t1, c1, l1) = rows
    joined = {"t": torch.stack([c0["t"], c1["t"]]),
              "prologue": [{k: torch.cat([a[k], b[k]]) for k in a}
                           for a, b in zip(c0["prologue"], c1["prologue"])],
              "unit": [{k: (torch.stack([a[k], b[k]], 1) if k == "pos"
                            else torch.cat([a[k], b[k]], 1)) for k in a}
                       for a, b in zip(c0["unit"], c1["unit"])]}
    assert joined["unit"][2]["pos"].shape == (1, 2, 64)
    both, new = lm.decode_step(p, cfg, torch.cat([t0, t1]), joined, spec,
                               dtype=torch.float32)
    torch.testing.assert_close(both[0], l0[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(both[1], l1[0], rtol=0, atol=1e-4)
    assert new["t"].tolist() == [71, 21]
    assert new["unit"][2]["pos"][0, 0, 70 % 64] == 70
    assert new["unit"][2]["pos"][0, 1, 20] == 20


# ---------------------------------------------------------------------------
# the default bfloat16 path and the model API
# ---------------------------------------------------------------------------
def test_bf16_default_path_matches_jax_bf16(weights):
    jcfg, cfg, jp, _ = weights
    jpb = jax.tree.map(lambda l: l.astype(jnp.bfloat16)
                       if l.dtype == jnp.float32 else l, jp)
    pb = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              torch.bfloat16)
    toks = _tokens(cfg, SEQ, seed=8)
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
    jl2, _ = jax.jit(lambda q, x, cc: jmodel.decode_step(q, x, cc, jspec))(
        jpb, jnp.asarray(toks[:, -1:]), jc)
    l2, _ = model.decode_step(pb, torch.from_numpy(toks[:, -1:]), c, spec)
    _close(l2, jl2, BF16_TOL)
    _close(l2[:, 0], logits[:, -1], BF16_TOL)


def test_make_batch_and_cache_specs_equal_jax():
    jcfg, cfg = _cfgs()
    jb = jbuild(jcfg).make_batch(24, 3, seed=7)
    b = build_model(cfg).make_batch(24, 3, seed=7, device="cpu")
    assert set(b) == set(jb) == {"tokens"}
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    for c, jc in ((cfg, jcfg), (get_config("recurrentgemma-9b"),
                                jget("recurrentgemma-9b"))):
        for name, shape in INPUT_SHAPES.items():
            assert dataclasses.asdict(cache_spec_for(c, shape)) == \
                dataclasses.asdict(jcache_spec_for(jc, J_SHAPES[name]))
