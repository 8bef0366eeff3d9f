"""Decoder-only LM and encoder-decoder assembly over the block zoo:
init, forward, loss, prefill, decode.

The parameter tree is the JAX package's: ``embed``, ``final_norm``,
``lm_head``, ``prologue`` (a list of blocks) and ``unit`` (one tree per
kind of the repeated pattern, every leaf STACKED ``(unit_repeats,
...)``), so weights carry across leaf by leaf.  The JAX package scans
the unit with remat; here the layers are a Python loop over the repeat
index ``r`` (no scan: PyTorch runs eagerly).  The forward checkpoints
each repeat of the unit
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, as the
JAX package wraps its scan body in ``jax.checkpoint``) whenever autograd
records, so the backward recomputes a repeat's activations instead of
keeping them: each kernel of the unit launches twice a forward and
backward, once in the forward and once in the recompute.  The decode cache
keeps the JAX layout ``{"prologue": [...], "unit": [per kind, every
leaf stacked], "t"}`` (``{"conv", "ssm"}`` for mamba, ``{"conv", "h"}``
for rec, ``{"k", "v", "pos"}`` for attn_local).

``init_lm`` builds a stacked leaf one layer at a time, each layer drawn
in float32 and cast to ``dtype`` as it is written, so a 7B model
initialises in the serve type without a float32 copy of the whole
(falcon-mamba-7b's stacked ``in_proj`` is 17 GB in float32).

A batch may carry a modality prefix, ``embeds`` (B, P, d), which goes in
front of the token embeddings (qwen2-vl's vision stub), and ``positions``,
(3, B, S) for M-RoPE; S counts the prefix, and ``lm_loss`` scores only
the token positions.  The MoE layers' router loss sums over the layers
into ``forward``'s aux (each checkpointed unit repeat returns its own
part).

An enc-dec config (seamless-m4t-large-v2) adds ``params["encoder"]``:
``{"unit": [attn_bidir blocks stacked (encoder_layers, ...)],
"final_norm"}``, drawn after the decoder's leaves as the JAX package
draws it.  ``_encode`` runs it over the batch's ``enc_embeds`` (B, Se, d)
in bfloat16 whatever the model's type (the JAX package casts the frames
to bfloat16, so a float32 model runs its encoder in bfloat16 too), with
positions 0..Se-1 and no segments, each layer checkpointed as the
decoder's unit repeats are; the decoder's ``attn_cross`` blocks attend
over its output (``ctx["enc_out"]``), which the decode cache keeps as
``enc_out``.  A batch's ``segments`` (B, S) confine the decoder's
self-attention to each packed document.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..configs.base import ArchConfig
from ..core.types import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .attention import CacheSpec
from .blocks import (apply_block, decode_block, init_block, init_block_cache,
                     prefill_block)
from .common import dense_init, embed_init, rms_norm, softmax_xent_logits


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def init_lm(gen, cfg: ArchConfig, device="cuda", dtype=torch.float32):
    def zeros():
        return torch.zeros((cfg.d_model,), dtype=dtype, device=device)

    params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                            device),
        "final_norm": zeros(),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab_size),
                              dtype=dtype, device=device),
        "prologue": [init_block(gen, cfg, kind, device, dtype)
                     for kind in cfg.pattern_prologue],
        "unit": [_init_stacked(gen, cfg, kind, cfg.unit_repeats, device,
                               dtype)
                 for kind in cfg.pattern_unit],
    }
    if cfg.is_encdec:
        params["encoder"] = {
            "unit": [_init_stacked(gen, cfg, "attn_bidir",
                                   cfg.encoder_layers, device, dtype)],
            "final_norm": zeros(),
        }
    return params


def _init_stacked(gen, cfg, kind, repeats, device, dtype):
    stacked = None
    for r in range(repeats):
        block = init_block(gen, cfg, kind, device, dtype)
        if stacked is None:
            stacked = tree_map(
                lambda l: l.new_empty((repeats,) + tuple(l.shape)), block)
        for dst, src in zip(tree_leaves(stacked), tree_leaves(block)):
            dst[r].copy_(src)
        del block
    return stacked


def _layer(stacked, r: int):
    """Layer ``r`` of a stacked tree (views, no copy)."""
    return tree_map(lambda l: l[r], stacked)


def _layers(stacked) -> list:
    """The layers of a stacked tree, each a tree of views (no copy).  One
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing each layer would make each layer's gradient a
    zero-filled tensor of the whole stack, summed over the layers."""
    leaves, treedef = tree_flatten(stacked)
    cols = [l.unbind(0) for l in leaves]
    return [tree_unflatten(treedef, list(layer)) for layer in zip(*cols)]


def _stack(trees):
    return tree_map(lambda *ls: torch.stack(ls), *trees)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _default_positions(cfg: ArchConfig, b, s, offset=0, device=None):
    """(B,S) positions offset..offset+S-1, the same (3,B,S) on each row
    for M-RoPE."""
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(b, s)
    if cfg.rope == "mrope":
        return pos[None].expand(3, b, s)
    return pos


def _embed_tokens(params, tokens, dtype, extra_embeds=None):
    """Token embeddings in ``dtype``, after the modality prefix
    ``extra_embeds`` (B,P,d) when there is one."""
    x = params["embed"].to(dtype)[torch.clamp_min(tokens, 0).long()]
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(dtype), x], dim=1)
    return x


def _inputs(params, cfg: ArchConfig, batch, dtype):
    """(x, positions): the embedded batch (prefix first) and its
    positions, the default ones over the whole length unless given."""
    x = _embed_tokens(params, batch["tokens"], dtype, batch.get("embeds"))
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, x.shape[0], x.shape[1],
                                       device=x.device)
    return x, positions


def _unit_loop(params_unit, x, cfg: ArchConfig, ctx, collect_cache=False,
               caches=None, kinds=None, repeats=None):
    """Run the repeated unit (the decoder's, or ``kinds`` over
    ``repeats``: the encoder's) over its repeats.

    collect_cache: prefill mode, returns stacked caches.
    caches: decode mode, consumes and returns stacked caches.
    Otherwise the forward, each repeat checkpointed when autograd
    records.
    """
    kinds = cfg.pattern_unit if kinds is None else kinds
    repeats = cfg.unit_repeats if repeats is None else repeats
    layers = [_layers(p) for p in params_unit]    # layers[j][r]
    if caches is not None:                       # ---- decode
        new = [[] for _ in kinds]
        cache_layers = [_layers(c) for c in caches]
        for r in range(repeats):
            for j, kind in enumerate(kinds):
                x, c = decode_block(layers[j][r], x, kind, cfg,
                                    cache_layers[j][r], ctx)
                new[j].append(c)
        return x, 0.0, [_stack(cs) for cs in new]

    if not collect_cache and torch.is_grad_enabled():
        def body(x, r):
            aux = 0.0
            for j, kind in enumerate(kinds):
                x, a, _ = apply_block(layers[j][r], x, kind, cfg, ctx)
                aux = aux + a
            return x, aux
        aux = 0.0
        for r in range(repeats):
            x, a = torch.utils.checkpoint.checkpoint(body, x, r,
                                                     use_reentrant=False)
            aux = aux + a
        return x, aux, None

    aux = 0.0
    out = [[] for _ in kinds]
    for r in range(repeats):
        for j, kind in enumerate(kinds):
            if collect_cache:                    # ---- prefill
                x, a, cache = prefill_block(layers[j][r], x, kind, cfg, ctx)
                out[j].append(cache)
            else:                                # ---- forward
                x, a, _ = apply_block(layers[j][r], x, kind, cfg, ctx)
            aux = aux + a
    return x, aux, ([_stack(cs) for cs in out] if collect_cache else None)


def _encode(params, cfg: ArchConfig, enc_embeds):
    """The bidirectional encoder over precomputed frame embeddings
    (B, Se, d), in bfloat16 whatever the model's type (the JAX package
    casts the frames so, its lm.py:116), positions 0..Se-1, no segments;
    its final RMS norm applied."""
    x = enc_embeds.to(torch.bfloat16)
    ctx = {"positions": _default_positions(cfg, x.shape[0], x.shape[1],
                                           device=x.device)}
    enc = params["encoder"]
    x, _, _ = _unit_loop(enc["unit"], x, cfg, ctx, kinds=("attn_bidir",),
                         repeats=cfg.encoder_layers)
    return rms_norm(x, enc["final_norm"])


def _context(params, cfg: ArchConfig, batch, positions, **extra):
    """The blocks' context: positions, the batch's encoder output for an
    enc-dec config, and ``extra``."""
    ctx = {"positions": positions, **extra}
    if cfg.is_encdec:
        ctx["enc_out"] = _encode(params, cfg, batch["enc_embeds"])
    return ctx


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(params, cfg: ArchConfig, batch, dtype=torch.bfloat16):
    """Full forward -> (logits (B,S,V), aux_loss).  batch: {"tokens"
    (B,S_tok) int}, optional "embeds" (B,P,d) modality prefix (S = P +
    S_tok), "positions" ((B,S), or (3,B,S) for M-RoPE), "segments"
    (B,S) (packed sequences) and, for an enc-dec config, "enc_embeds"
    (B,Se,d).  Each unit repeat is checkpointed when autograd records."""
    x, positions = _inputs(params, cfg, batch, dtype)
    ctx = _context(params, cfg, batch, positions,
                   segments=batch.get("segments"))
    aux = 0.0
    for p, kind in zip(params["prologue"], cfg.pattern_prologue):
        x, a, _ = apply_block(p, x, kind, cfg, ctx)
        aux = aux + a
    x, a, _ = _unit_loop(params["unit"], x, cfg, ctx)
    aux = aux + a
    x = rms_norm(x, params["final_norm"])
    return x @ params["lm_head"].to(x.dtype), aux


def lm_loss(params, cfg: ArchConfig, batch, aux_weight: float = 0.01,
            dtype=torch.bfloat16):
    """Next-token loss: the cross entropy of each token position's logits
    (the modality prefix's are left out) against the next token (the
    last position's label is -1, ignored), in float32, plus
    ``aux_weight`` times the blocks' auxiliary loss (the MoE router
    loss; 0 for the other kinds).  An optional "loss_mask" (B,S) zeroes
    targets, as in the JAX package."""
    logits, aux = forward(params, cfg, batch, dtype)
    tokens = batch["tokens"]
    logits = logits[:, logits.shape[1] - tokens.shape[1]:]
    labels = torch.cat([tokens[:, 1:].to(torch.int32),
                        torch.full((tokens.shape[0], 1), -1,
                                   dtype=torch.int32,
                                   device=tokens.device)], dim=1)
    loss = softmax_xent_logits(logits, labels, mask=batch.get("loss_mask"))
    return loss + aux_weight * aux


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------
def prefill(params, cfg: ArchConfig, batch, spec: CacheSpec,
            dtype=torch.bfloat16):
    """Prefill the cache from a full prompt (after its modality prefix,
    when the batch has one); returns (last_logits (B,1,V), cache), the
    cache's step ``t`` the prompt's whole length."""
    x, positions = _inputs(params, cfg, batch, dtype)
    ctx = _context(params, cfg, batch, positions, spec=spec)
    caches = {"prologue": [], "unit": None}
    for p, kind in zip(params["prologue"], cfg.pattern_prologue):
        x, _, cache = prefill_block(p, x, kind, cfg, ctx)
        caches["prologue"].append(cache)
    x, _, caches["unit"] = _unit_loop(params["unit"], x, cfg, ctx,
                                      collect_cache=True)
    x = rms_norm(x, params["final_norm"])
    logits = x[:, -1:, :] @ params["lm_head"].to(x.dtype)
    caches["t"] = torch.tensor(x.shape[1], dtype=torch.int32,
                               device=x.device)
    if cfg.is_encdec:
        caches["enc_out"] = ctx["enc_out"]
    return logits, caches


def init_cache(cfg: ArchConfig, batch_size: int, spec: CacheSpec,
               dtype=torch.bfloat16, device="cuda", enc_len: int = 0):
    """Empty cache for decode-from-scratch; an enc-dec config's holds a
    zero encoder output and cross K/V over ``enc_len`` positions."""
    def one(kind):
        return init_block_cache(cfg, kind, batch_size, spec, dtype, device,
                                enc_len)

    def stacked(kind):
        return tree_map(lambda l: l[None].expand(
            (cfg.unit_repeats,) + tuple(l.shape)).clone(), one(kind))

    caches = {
        "prologue": [one(kind) for kind in cfg.pattern_prologue],
        "unit": [stacked(kind) for kind in cfg.pattern_unit],
        "t": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.is_encdec:
        caches["enc_out"] = torch.zeros((batch_size, enc_len, cfg.d_model),
                                        dtype=dtype, device=device)
    return caches


def decode_step(params, cfg: ArchConfig, token, cache, spec: CacheSpec,
                dtype=torch.bfloat16):
    """One decode step. token: (B,1) int -> (logits (B,1,V), new cache).

    ``cache["t"]`` is the step, a scalar for the whole batch or one per
    row, shape (B,) (the Engine's slots); each row takes its RoPE
    position from its own step ((3,B,1) for M-RoPE)."""
    b = token.shape[0]
    t = cache["t"]
    x = _embed_tokens(params, token, dtype)
    positions = (t if t.dim() == 1 else t.expand(b))[:, None]
    if cfg.rope == "mrope":
        positions = positions[None].expand(3, b, 1)
    ctx = {"positions": positions, "t": t, "spec": spec}
    new_cache = {"prologue": [], "t": t + 1}
    if cfg.is_encdec:        # the blocks read the cross caches
        new_cache["enc_out"] = cache["enc_out"]
    for p, kind, c in zip(params["prologue"], cfg.pattern_prologue,
                          cache["prologue"]):
        x, c = decode_block(p, x, kind, cfg, c, ctx)
        new_cache["prologue"].append(c)
    x, _, new_cache["unit"] = _unit_loop(params["unit"], x, cfg, ctx,
                                         caches=cache["unit"])
    x = rms_norm(x, params["final_norm"])
    return x @ params["lm_head"].to(x.dtype), new_cache
