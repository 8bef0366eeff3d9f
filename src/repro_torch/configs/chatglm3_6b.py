"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d (partial) RoPE. [arXiv:2406.12793]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    arch_type="dense",
    source="arXiv:2406.12793 (ChatGLM)",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65_024,
    qkv_bias=True,
    rope="2d",
    pattern_unit=("attn",),
)
