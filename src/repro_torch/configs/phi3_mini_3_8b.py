"""phi3-mini-3.8b [arXiv:2404.14219; unverified] — dense, RoPE SwiGLU GQA(kv=32=MHA)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064, head_dim=96,
    norm="rmsnorm", mlp="swiglu", pos="rope",
    source="arXiv:2404.14219; unverified",
)
