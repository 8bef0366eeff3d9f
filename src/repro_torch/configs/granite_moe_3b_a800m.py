"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512, vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]

dense_all MoE execution: 40 tiny experts (512-wide) make capacity-based
dispatch tensors larger than simply evaluating all experts; see DESIGN.md
Sec. 5 and the §Perf iteration log for the measured trade-off.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    source="hf:ibm-granite/granite-3.0 MoE family",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    rope="1d",
    pattern_unit=("attn",),
    num_experts=40,
    experts_per_tok=8,
    # §Perf: dense-all-experts costs E/top_k = 5x FLOPs and its (B,S,E,ff)
    # activations blew past HBM once dispatch became cheap (grouped one-hot,
    # EXPERIMENTS.md hillclimb 3); measured dispatch beats dense_all
    # 12.8 s vs 33.7 s collective and 28 vs 69 GB/dev on train_4k.
    moe_mode="dispatch",
)
