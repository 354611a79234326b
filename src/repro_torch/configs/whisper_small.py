"""whisper-small [arXiv:2212.04356; unverified] — enc-dec, conv frontend (stub)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, head_dim=64,
    norm="layernorm", mlp="gelu", pos="sinusoidal", use_bias=True,
    encoder_layers=12, frontend="conv_stub", n_prefix_tokens=1500,
    source="arXiv:2212.04356; unverified",
)
