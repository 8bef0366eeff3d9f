"""Architecture configuration schema + input-shape registry.

Every assigned architecture gets one ``<id>.py`` in this package with the
exact dimensions from the assignment (source cited).  ``reduced()`` yields
the small same-family variant used by the CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # dense|moe|ssm|hybrid|vlm|audio
    source: str                     # citation
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention details
    qkv_bias: bool = False
    rope: str = "1d"                # none|1d|2d|mrope
    window: int | None = None       # sliding-window size for attn_local
    # layer pattern
    pattern_prologue: Tuple[str, ...] = ()
    pattern_unit: Tuple[str, ...] = ("attn",)
    unit_repeats: int = 0           # derived in __post_init__ if 0
    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_mode: str = "dispatch"      # dispatch|dense_all
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM / recurrent
    d_inner: int = 0
    ssm_state: int = 0
    conv_width: int = 4
    rglru_heads: int = 0
    # encoder-decoder
    encoder_layers: int = 0
    max_encoder_len: int = 4096
    # modality frontend stub (vlm/audio): embeddings provided as input
    modality: str = "text"          # text|vision|audio
    modality_tokens: int = 0        # prefix embedding positions
    # long-context decode variant: dense archs may opt into a sliding
    # window for the long_500k shape (sub-quadratic requirement)
    long_context_window: int | None = 4096
    # int8 KV cache for decode shapes (serving memory lever, §Perf)
    kv_quant: bool = False

    def __post_init__(self):
        if self.unit_repeats == 0:
            n_body = self.num_layers - len(self.pattern_prologue)
            assert n_body % len(self.pattern_unit) == 0, \
                (self.name, n_body, self.pattern_unit)
            object.__setattr__(self, "unit_repeats",
                               n_body // len(self.pattern_unit))
        assert (len(self.pattern_prologue)
                + len(self.pattern_unit) * self.unit_repeats
                == self.num_layers), self.name

    # ------------------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode 500k+ contexts with bounded state?"""
        kinds = set(self.pattern_prologue) | set(self.pattern_unit)
        if "attn" in kinds:         # full attention present
            return self.long_context_window is not None
        return True                 # ssm / local-attn hybrid

    @property
    def attn_kinds(self):
        return [k for k in (list(self.pattern_prologue)
                            + list(self.pattern_unit))
                if k.startswith("attn")]

    def reduced(self) -> "ArchConfig":
        """Small same-family variant: <=2 unit repeats, d_model<=256,
        <=4 experts — used by the CPU smoke tests."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        head_dim = max(32, d_model // heads)
        experts = min(self.num_experts, 4) if self.num_experts else 0
        top_k = min(self.experts_per_tok, experts) if experts else 0
        prologue = self.pattern_prologue[:2]
        repeats = 1 if self.pattern_unit else 0
        num_layers = len(prologue) + len(self.pattern_unit) * repeats
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            pattern_prologue=prologue,
            unit_repeats=repeats,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 64) if self.window else self.window,
            num_experts=experts,
            experts_per_tok=top_k,
            d_inner=min(self.d_inner, 256) if self.d_inner else 0,
            rglru_heads=min(self.rglru_heads, 4) if self.rglru_heads else 0,
            encoder_layers=min(self.encoder_layers, 2)
            if self.encoder_layers else 0,
            max_encoder_len=min(self.max_encoder_len, 64),
            modality_tokens=min(self.modality_tokens, 8)
            if self.modality_tokens else 0,
            long_context_window=min(self.long_context_window, 64)
            if self.long_context_window else None,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train|prefill|decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
