"""Public model API: build a model from an ArchConfig, its serve functions
(forward, prefill, decode, empty cache) and concrete input batches.

``Model.dtype`` is the activation type of every call, bfloat16 by
default as in the JAX package (whose ``Model`` always runs bf16); the
parity tests build ``Model(cfg, torch.float32)``.

Not ported yet: ``input_specs`` (the dry-runs' shape stand-ins, ROADMAP
A8), ``Model.loss`` and ``ModelGradFn`` (the training slice, A7).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ArchConfig, InputShape
from .attention import CacheSpec
from .lm import decode_step, forward, init_cache, init_lm, prefill


def cache_spec_for(cfg: ArchConfig, shape: InputShape) -> CacheSpec:
    """Cache geometry for a decode shape.  ``long_500k`` uses the arch's
    sub-quadratic mechanism: native (SSM/local-attn) or the sliding-window
    variant for dense archs."""
    if shape.name == "long_500k":
        w = cfg.long_context_window
        if w is not None:
            return CacheSpec(capacity=w, window=w, quant=cfg.kv_quant)
        return CacheSpec(capacity=cfg.window or 1, window=cfg.window,
                         quant=cfg.kv_quant)
    return CacheSpec(capacity=shape.seq_len, window=None,
                     quant=cfg.kv_quant)


def supports_shape(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    if shape.name == "long_500k":
        if cfg.is_encdec:
            return False, ("enc-dec speech model: 500k-token decode out of "
                           "scope")
        if not cfg.subquadratic:
            return False, "full-attention arch without sliding-window variant"
    return True, ""


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    dtype: torch.dtype = torch.bfloat16      # activations

    # -- construction ----------------------------------------------------
    def init(self, gen, device="cuda", dtype=torch.float32):
        """Parameters drawn from ``gen`` (a ``torch.Generator`` on
        ``device``), stored in ``dtype``."""
        return init_lm(gen, self.cfg, device, dtype)

    # -- serve -------------------------------------------------------------
    def forward(self, params, batch):
        return forward(params, self.cfg, batch, self.dtype)

    def prefill(self, params, batch, spec: CacheSpec):
        return prefill(params, self.cfg, batch, spec, self.dtype)

    def decode_step(self, params, token, cache, spec: CacheSpec):
        return decode_step(params, self.cfg, token, cache, spec, self.dtype)

    def init_cache(self, batch_size: int, spec: CacheSpec, device="cuda"):
        return init_cache(self.cfg, batch_size, spec, self.dtype, device)

    # -- concrete batches ----------------------------------------------------
    def make_batch(self, seq_len: int, batch_size: int, seed: int = 0,
                   device="cuda"):
        """Tokens from the JAX package's numpy stream (the same seed gives
        the same tokens).  The modality prefix, M-RoPE positions and the
        encoder input wait for their families (ROADMAP A7)."""
        cfg = self.cfg
        if cfg.modality == "vision" or cfg.rope == "mrope" or cfg.is_encdec:
            raise NotImplementedError(f"{cfg.name}: its family is not "
                                      f"ported yet (ROADMAP A7)")
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab_size, size=(batch_size, seq_len))
        return {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                          device=device)}


def build_model(cfg: ArchConfig, dtype=torch.bfloat16) -> Model:
    return Model(cfg, dtype)
