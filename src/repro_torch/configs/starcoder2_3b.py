"""starcoder2-3b [arXiv:2402.19173; hf] — GQA kv=2, RoPE, LayerNorm, GELU MLP, biases."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab=49152, head_dim=128,
    norm="layernorm", mlp="gelu", pos="rope", use_bias=True,
    source="arXiv:2402.19173; hf",
)
