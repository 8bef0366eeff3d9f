"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) expert
d_ff=8192, vocab=202048, MoE 16 experts top-1 + shared expert, early
fusion. [hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    rope="1d",
    pattern_unit=("attn",),
    num_experts=16,
    experts_per_tok=1,
    moe_mode="dispatch",
    shared_expert=True,
)
