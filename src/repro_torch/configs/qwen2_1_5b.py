"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias. [arXiv:2407.10671]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    source="arXiv:2407.10671 (Qwen2)",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    rope="1d",
    pattern_unit=("attn",),
)
