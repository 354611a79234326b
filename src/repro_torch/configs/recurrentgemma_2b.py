"""recurrentgemma-2b [arXiv:2402.19427; hf] — RG-LRU + local attention, 1:2 pattern."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "attn_local"), window=2048,
    lru_width=2560,
    norm="rmsnorm", mlp="swiglu", pos="rope", tie_embeddings=True,
    source="arXiv:2402.19427; hf",
)
