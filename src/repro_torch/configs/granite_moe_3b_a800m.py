"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf] — MoE 40e top-8."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64,
    moe=MoEConfig(n_experts=40, experts_per_token=8, route_group=512),
    norm="rmsnorm", mlp="swiglu", pos="rope", tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
