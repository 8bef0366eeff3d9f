"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1 attn : 2 rec.

38 layers, d_model=4096, 16 heads (GQA kv=1 => MQA), d_ff=12288,
vocab=256000, local-attention window 2048. [arXiv:2402.19427]
38 = 2 recurrent prologue blocks + 12 x (rec, rec, local-attn).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    rope="1d",
    window=2048,
    pattern_prologue=("rec", "rec"),
    pattern_unit=("rec", "rec", "attn_local"),
    d_inner=4096,
    rglru_heads=16,
    conv_width=4,
    long_context_window=None,       # natively sub-quadratic
)
