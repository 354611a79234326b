"""qwen3-32b [hf:Qwen/Qwen3-8B; hf] — qk_norm, GQA kv=8, head_dim 128."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128,
    norm="rmsnorm", mlp="swiglu", pos="rope", qk_norm=True,
    rope_theta=1e6, microbatches=4,
    source="hf:Qwen/Qwen3-8B; hf",
)
