"""paligemma-3b [arXiv:2407.07726; hf] — SigLIP (stub) + gemma backbone, prefix-LM."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256,
    norm="rmsnorm", mlp="swiglu", pos="rope", tie_embeddings=True,
    frontend="siglip_stub", n_prefix_tokens=256,
    source="arXiv:2407.07726; hf",
)
