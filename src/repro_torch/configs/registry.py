"""Architecture registry: --arch <id> resolution + smoke-config derivation
(the port's copy of the JAX package's ``configs/registry.py``)."""

from __future__ import annotations

import dataclasses
import importlib

from .base import ArchConfig, MoEConfig

ARCH_IDS = [
    "grok-1-314b",
    "granite-moe-3b-a800m",
    "phi3-mini-3.8b",
    "stablelm-1.6b",
    "qwen3-32b",
    "starcoder2-3b",
    "recurrentgemma-2b",
    "paligemma-3b",
    "rwkv6-3b",
    "whisper-small",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: small widths/depths,
    few experts, tiny vocab; fp32 numerics."""
    cfg = get_config(arch_id)
    n_layers = min(cfg.n_layers, len(cfg.block_pattern) if cfg.block_pattern else 2)
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(n_experts=4, experts_per_token=min(2, cfg.moe.experts_per_token))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=512,
        head_dim=16,
        moe=moe,
        window=min(cfg.window, 16) if cfg.window else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_prefix_tokens=8 if cfg.n_prefix_tokens else 0,
        lru_width=64 if cfg.lru_width else None,
        rnn_head_dim=16,
        param_dtype="float32",
        compute_dtype="float32",
        optimizer_dtype="float32",
        microbatches=1,
        remat=False,
    )
