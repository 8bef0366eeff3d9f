"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias. [hf:Qwen/Qwen2.5 family]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    source="hf:Qwen/Qwen2.5 family",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152_064,
    qkv_bias=True,
    rope="1d",
    pattern_unit=("attn",),
)
