"""seamless-m4t-large-v2 [audio]: encoder-decoder, 24L+24L d_model=1024
16H (kv=16, MHA) d_ff=8192 vocab=256206. [arXiv:2308.11596]

The speech frontend (mel-spectrogram + conformer feature extractor) is a
stub per the assignment: ``input_specs`` provides precomputed frame
embeddings (B, frames, d_model) for the encoder.  We implement the
transformer encoder + autoregressive text decoder with cross-attention.
Adaptation note (DESIGN.md): relative position bias is replaced with RoPE.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    source="arXiv:2308.11596 (SeamlessM4T v2)",
    num_layers=24,                 # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    rope="1d",
    pattern_unit=("attn_cross",),
    modality="audio",
    max_encoder_len=4096,
    long_context_window=None,      # 500k decode out of scope (DESIGN.md)
)
