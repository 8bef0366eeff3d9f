"""Public model API: build a model from an ArchConfig, its loss and serve
functions (forward, prefill, decode, empty cache), concrete input
batches, and ``ModelGradFn``, the picklable gradient of a real model's
LM loss that the cluster's ``--preset lm`` hands its workers.

``Model.dtype`` is the activation type of every call, bfloat16 by
default as in the JAX package (whose ``Model`` always runs bf16); the
parity tests build ``Model(cfg, torch.float32)``.

Not ported yet: ``input_specs`` (the dry-runs' shape stand-ins) and
``ModelGradFn``'s per-worker mesh (both ROADMAP A8).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ArchConfig, InputShape
from ..core.types import tree_flatten, tree_unflatten
from .attention import CacheSpec
from .lm import decode_step, forward, init_cache, init_lm, lm_loss, prefill


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

    # -- train -------------------------------------------------------------
    def loss(self, params, batch):
        return lm_loss(params, self.cfg, batch, dtype=self.dtype)

    # -- serve -------------------------------------------------------------
    def forward(self, params, batch):
        return forward(params, self.cfg, batch, self.dtype)

    def prefill(self, params, batch, spec: CacheSpec):
        return prefill(params, self.cfg, batch, spec, self.dtype)

    def decode_step(self, params, token, cache, spec: CacheSpec):
        return decode_step(params, self.cfg, token, cache, spec, self.dtype)

    def init_cache(self, batch_size: int, spec: CacheSpec, device="cuda"):
        enc_len = self.cfg.max_encoder_len if self.cfg.is_encdec else 0
        return init_cache(self.cfg, batch_size, spec, self.dtype, device,
                          enc_len)

    # -- concrete batches ----------------------------------------------------
    def make_batch(self, seq_len: int, batch_size: int, seed: int = 0,
                   device="cuda"):
        """A batch from the JAX package's numpy stream, drawn in its
        order, so the same seed gives the same batch: the tokens (B, S -
        P), then for a vision config the modality prefix ``embeds`` (B,
        P, d) ~ 0.02 N(0, 1) in bfloat16 (P = ``modality_tokens``), for
        M-RoPE the (3, B, S) positions, and for an enc-dec config the
        encoder's frames ``enc_embeds`` (B, min(max_encoder_len, S), d)
        ~ 0.02 N(0, 1) in bfloat16."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        p = cfg.modality_tokens if cfg.modality == "vision" else 0
        tokens = rng.integers(0, cfg.vocab_size,
                              size=(batch_size, seq_len - p))
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                           device=device)}
        if p:
            embeds = rng.normal(size=(batch_size, p, cfg.d_model)) * 0.02
            batch["embeds"] = torch.as_tensor(
                embeds.astype(np.float32), device=device).to(torch.bfloat16)
        if cfg.rope == "mrope":
            batch["positions"] = torch.arange(
                seq_len, dtype=torch.int32, device=device).expand(
                    3, batch_size, seq_len).clone()
        if cfg.is_encdec:
            enc = min(cfg.max_encoder_len, seq_len)
            frames = rng.normal(size=(batch_size, enc, cfg.d_model)) * 0.02
            batch["enc_embeds"] = torch.as_tensor(
                frames.astype(np.float32), device=device).to(torch.bfloat16)
        return batch


def build_model(cfg: ArchConfig, dtype=torch.bfloat16) -> Model:
    return Model(cfg, dtype)


# a tiny-but-real reduction used by the cluster's lm preset: real
# attention / mlp / embedding leaves (ragged shapes, the full pack
# surface) at CPU smoke-test cost
TINY_LM_OVERRIDES = dict(vocab_size=128, d_model=64, num_heads=4,
                         num_kv_heads=2, head_dim=32, d_ff=256)


class ModelGradFn:
    """Picklable gradient of a real model's LM loss.

    It carries only ``(config_name, reduced, overrides, mesh_shape)`` and
    builds the model and its gradient lazily, in the process that calls
    it, as the JAX package's ``ModelGradFn`` does (see
    ``models.toy.ClassifierGradFn`` for the toy twin).  ``mesh_shape``
    may be None or (1, 1): one device, no constraint; a larger
    per-worker mesh raises (ROADMAP A8).

    ``__call__(params, tokens)`` takes the raw (B, S) token tensor the
    synthetic ``LMTask`` emits (the cluster's wire convention for the lm
    preset), wraps it into ``Model.loss``'s batch dict and returns the
    gradient tree.  The model computes in bfloat16 from the parameters'
    own leaves (float32 at the master), so each gradient is the float32
    widening of a bfloat16-rounded one wherever the forward casts a leaf,
    as ``jax.grad`` of float32 parameters through the JAX package's
    bfloat16 forward gives it.  Tokens alone cannot feed an enc-dec
    config's encoder (the JAX package's ``ModelGradFn`` fails on one at
    its first gradient): the constructor refuses such a config with a
    ValueError.
    """

    def __init__(self, config_name: str, *, reduced: bool = True,
                 overrides: dict | None = None,
                 mesh_shape: tuple[int, int] | None = None):
        self.config_name = str(config_name)
        self.reduced = bool(reduced)
        self.overrides = dict(overrides or {})
        self.mesh_shape = tuple(mesh_shape) if mesh_shape else None
        if self.mesh_shape not in (None, (1, 1)):
            raise NotImplementedError(
                f"ModelGradFn runs on one device; a per-worker mesh "
                f"{self.mesh_shape} is not ported yet: ROADMAP A8")
        if self.build_config().is_encdec:
            raise ValueError(f"{self.config_name} is an enc-dec config: "
                             f"the lm preset's token batches carry no "
                             f"encoder input")
        self._grad = None

    def __getstate__(self):
        return {"config_name": self.config_name, "reduced": self.reduced,
                "overrides": self.overrides,
                "mesh_shape": self.mesh_shape}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._grad = None

    # -- lazy per-process construction -----------------------------------
    def build_config(self) -> ArchConfig:
        from ..configs import get_config
        cfg = get_config(self.config_name)
        if self.reduced:
            cfg = cfg.reduced()
        return dataclasses.replace(cfg, **self.overrides)

    def build_model(self) -> Model:
        return build_model(self.build_config())

    def init(self, gen, device="cuda"):
        """float32 parameters drawn from ``gen`` (a ``torch.Generator``
        on ``device``)."""
        return self.build_model().init(gen, device=device)

    def _build(self):
        model = self.build_model()

        def grad(params, tokens):
            leaves, treedef = tree_flatten(params)
            leaves = [l.detach().requires_grad_(True) for l in leaves]
            with torch.enable_grad():
                loss = model.loss(tree_unflatten(treedef, leaves),
                                  {"tokens": tokens})
                grads = torch.autograd.grad(loss, leaves)
            return tree_unflatten(treedef, list(grads))
        return grad

    def __call__(self, params, tokens):
        if self._grad is None:
            self._grad = self._build()
        return self._grad(params, tokens)
