"""grok-1-314b [hf:xai-org/grok-1; unverified] — 64L MoE 8e top-2."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, head_dim=128,
    moe=MoEConfig(n_experts=8, experts_per_token=2, route_group=512),
    norm="rmsnorm", mlp="swiglu", pos="rope",
    optimizer_dtype="bfloat16",   # 314B * 12B/param / 256 chips must fit v5e HBM
    microbatches=8,
    source="hf:xai-org/grok-1; unverified",
)
