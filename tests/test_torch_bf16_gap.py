"""Where recurrentgemma's bfloat16 gap between the two packages comes from.

At bfloat16 the port's recurrentgemma logits and the JAX package's differ
by about 0.13 at 5 layers (``tests/test_torch_recurrentgemma.py`` holds
them to 0.15) and by up to about 0.21 at 8 layers (two unit repeats).
This file apportions the 8-layer gap by swapping one part of the port's
model at a time for the JAX package's own (run jitted, as the JAX model
runs it, through numpy):

* attention: the JAX model's chunked ``flash_attention``, which rounds
  each probability tile to bfloat16 before its PV product (its q * scale
  is exact at head_dim 256: the scale is 1/16);
* the RG-LRU block: the JAX ``apply_rglru`` (XLA fuses its bfloat16
  sigmoid, gelu and gate chain; PyTorch rounds after each op);
* both.

Each part is also measured alone on the same inputs: attention at
recurrentgemma-9b's head layout (H=16, K=1, hd=256) on a narrow sequence,
the RG-LRU block at the reduced widths.  A model of the tensor-core
kernel's rounding (scores in float32, P rounded to bfloat16 before PV,
the sum l from the float32 P) is measured beside them, since that kernel
moves the port's P rounding to where FlashAttention and the JAX model
put it.  Run with ``-s`` to see the numbers (one JSON line a test).

Tolerances stated here: attention alone within 3e-2 of the float32
computation (the JAX package's bfloat16 kernel tolerance) on each side;
the RG-LRU blocks within 0.05 of each other (a handful of bfloat16 steps
of outputs of magnitude about 1); the 8-layer logits within 0.25 (each
side's bfloat16 logits are 0.17 to 0.23 from the port's float32 logits
here, so the two bfloat16 paths can differ by that much), and swapping
both parts for the JAX package's lowers the gap's root mean square.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.models.api import build_model as jbuild
from repro.models.attention import flash_attention as jflash
from repro.models.recurrent import apply_rglru as japply_rglru
from repro.models.recurrent import init_rglru as jinit_rglru

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, params_from_numpy
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models import blocks
from repro_torch.models.api import build_model
from repro_torch.models.recurrent import apply_rglru

torch.set_num_threads(1)

ATTN_TOL = 3e-2
RGLRU_TOL = 0.05
EIGHT_LAYER_TOL = 0.25
SEQ = 90

_jflash = jax.jit(jflash, static_argnames=("causal", "window"))
_jrglru = jax.jit(japply_rglru)


def _to_jax(t):
    a = jnp.asarray(t.detach().float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def _flash_via_jax(q, k, v, *, causal=True, window=None, segments=None):
    assert causal and segments is None
    return _to_torch(_jflash(_to_jax(q), _to_jax(k), _to_jax(v),
                             causal=True, window=window), q.dtype)


def _rglru_via_jax(params, x, state=None):
    assert state is None
    y, st = _jrglru(jax.tree.map(_to_jax, params), _to_jax(x))
    return _to_torch(y, x.dtype), {"conv": _to_torch(st["conv"], x.dtype),
                                   "h": _to_torch(st["h"], torch.float32)}


def _p_bf16_attention(q, k, v, window):
    """The tensor-core kernel's rounding on the CPU: float32 scores of
    the bfloat16 inputs, scaled after Q K^T, P = exp(s - m) rounded to
    bfloat16 for the PV product, l summed from the float32 P."""
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s, hd = q.shape[1], q.shape[-1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))
    pos = torch.arange(s)
    mask = (pos[None, :] <= pos[:, None]) & \
        (pos[:, None] - pos[None, :] < window)
    sc = torch.where(mask, sc, torch.tensor(-1e30))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), v.float()) \
        / p.sum(-1, keepdim=True)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("window", [64, 2048])
def test_attention_alone_at_recurrentgemma_heads(window):
    rng = np.random.default_rng(window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()
        for shape in ((1, 96, 16, 256), (1, 96, 1, 256), (1, 96, 1, 256)))
    assert float(jnp.asarray(1.0 / 16.0, jnp.bfloat16)) == 1.0 / 16.0
    truth = swa_attention(q.float(), k.float(), v.float(), window)
    outs = {"port_plain": swa_attention(q, k, v, window),
            "jax_flash": _flash_via_jax(q, k, v, window=window),
            "p_bf16_model": _p_bf16_attention(q, k, v, window)}
    errs = {n: float((o.float() - truth).abs().max())
            for n, o in outs.items()}
    port_vs_jax = float((outs["port_plain"].float()
                         - outs["jax_flash"].float()).abs().max())
    model_vs_jax = float((outs["p_bf16_model"].float()
                          - outs["jax_flash"].float()).abs().max())
    print(json.dumps(dict(test="attention_alone", window=window,
                          err_vs_f32=errs,
                          port_plain_vs_jax_flash=port_vs_jax,
                          p_bf16_model_vs_jax_flash=model_vs_jax)))
    assert all(e <= ATTN_TOL for e in errs.values()), errs


def test_rglru_block_alone():
    jcfg = jget("recurrentgemma-9b").reduced()
    jp = jinit_rglru(jax.random.PRNGKey(3), jcfg.d_model, jcfg.d_inner,
                     jcfg.rglru_heads, jcfg.conv_width)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, SEQ, jcfg.d_model)).astype(np.float32))
    y32, _ = apply_rglru(p, x)
    pb = {k: t.bfloat16() if t.is_floating_point() else t
          for k, t in p.items()}
    y_port, _ = apply_rglru(pb, x.bfloat16())
    y_jax, _ = _rglru_via_jax(pb, x.bfloat16())
    gap = float((y_port.float() - y_jax.float()).abs().max())
    print(json.dumps(dict(
        test="rglru_block_alone", port_vs_jax=gap,
        port_vs_f32=float((y_port.float() - y32).abs().max()),
        jax_vs_f32=float((y_jax.float() - y32).abs().max()),
        output_abs_max=float(y32.abs().max()))))
    assert gap <= RGLRU_TOL


@pytest.fixture(scope="module")
def eight_layers():
    def two(c):
        return dataclasses.replace(c.reduced(), unit_repeats=2,
                                   num_layers=8)
    jcfg, cfg = two(jget("recurrentgemma-9b")), \
        two(get_config("recurrentgemma-9b"))
    jp = jax.jit(lambda k: jlm.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    jpb = jax.tree.map(lambda l: l.astype(jnp.bfloat16)
                       if l.dtype == jnp.float32 else l, jp)
    tree = jax.tree.map(np.asarray, jp)
    return (jcfg, jpb, jax.jit(jbuild(jcfg).forward), cfg,
            lm_params_from_numpy(tree, "cpu", torch.bfloat16),
            lm_params_from_numpy(tree, "cpu"))


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_eight_layer_gap_apportioned(eight_layers, seed, monkeypatch):
    jcfg, jpb, jforward, cfg, pb, p32 = eight_layers
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(2, SEQ)).astype(np.int32)
    jl = np.asarray(jforward(jpb, {"tokens": jnp.asarray(toks)})[0]
                    .astype(jnp.float32))
    batch = {"tokens": torch.from_numpy(toks)}
    f32 = build_model(cfg, torch.float32).forward(p32, batch)[0].numpy()
    model = build_model(cfg)
    swaps = {"none": {}, "attention": {"flash_attention": _flash_via_jax},
             "rglru": {"apply_rglru": _rglru_via_jax},
             "both": {"flash_attention": _flash_via_jax,
                      "apply_rglru": _rglru_via_jax},
             "p_bf16_attention": {"flash_attention": (
                 lambda q, k, v, causal=True, window=None, segments=None:
                 _p_bf16_attention(q, k, v, window))}}
    gaps = {}
    for name, swap in swaps.items():
        with monkeypatch.context() as m:
            for attr, fn in swap.items():
                m.setattr(blocks, attr, fn)
            with torch.no_grad():
                lo = model.forward(pb, batch)[0].float().numpy()
        gaps[name] = {"max": float(np.abs(lo - jl).max()),
                      "rms": float(np.sqrt(np.mean((lo - jl) ** 2))),
                      "max_vs_port_f32": float(np.abs(lo - f32).max())}
    print(json.dumps(dict(test="eight_layer_gap", seed=seed, gaps=gaps,
                          jax_bf16_vs_port_f32=float(np.abs(jl - f32).max()))))
    assert gaps["none"]["max"] <= EIGHT_LAYER_TOL
    assert gaps["both"]["rms"] < gaps["none"]["rms"]
