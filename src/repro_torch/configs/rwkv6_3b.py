"""rwkv6-3b (Finch) [arXiv:2404.05892; hf] — attention-free, data-dependent decay."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=0, d_ff=8960,
    vocab=65536, head_dim=64, rnn_head_dim=64,
    block_pattern=("rwkv",),
    norm="layernorm", mlp="gelu", pos="none",
    source="arXiv:2404.05892; hf",
)
