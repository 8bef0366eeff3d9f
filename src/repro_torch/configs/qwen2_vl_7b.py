"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE + dynamic resolution. [arXiv:2409.12191]

The vision tower (ViT + merger) is a stub per the assignment:
``input_specs`` provides precomputed patch embeddings (B, P, d_model) and
3d M-RoPE position ids; this config implements the language backbone.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    source="arXiv:2409.12191 (Qwen2-VL)",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    qkv_bias=True,
    rope="mrope",
    pattern_unit=("attn",),
    modality="vision",
    modality_tokens=256,
)
