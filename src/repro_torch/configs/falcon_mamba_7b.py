"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free Mamba-1,
d_inner=8192, ssm_state=16, vocab=65024. [arXiv:2410.05355]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    source="arXiv:2410.05355 (Falcon-Mamba)",
    num_layers=64,
    d_model=4096,
    num_heads=1,                  # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,                       # mamba blocks have no separate MLP
    vocab_size=65_024,
    rope="none",
    pattern_unit=("mamba",),
    d_inner=8192,
    ssm_state=16,
    conv_width=4,
    long_context_window=None,     # natively sub-quadratic
)
