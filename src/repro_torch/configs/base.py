"""Architecture + run configuration, the port's copy of the JAX package's
``configs/base.py``.

One ``ArchConfig`` per assigned architecture lives in ``configs/<id>.py``
with the exact published dimensions; ``registry.smoke_config`` returns a
reduced config of the same family for CPU tests. Input shapes (the assigned
shape set) are ``ShapeConfig``s. The fields and the parameter counts are the
reference's; only ``pdtype`` / ``cdtype`` differ, returning ``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    # router options
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    # tokens per routing group (0 = whole sequence). Dispatch-einsum cost per
    # token is f·K·G·D — linear in G — so grouped routing cuts the one-hot
    # dispatch overhead without touching expert FLOPs (perf iteration A1).
    route_group: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads

    # block structure
    block_pattern: Optional[tuple] = None  # e.g. ("rglru","rglru","attn"); None => all attn
    window: int = 0                   # sliding-window size for "attn_local" blocks
    moe: Optional[MoEConfig] = None

    # flavor flags
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    mlp: str = "swiglu"               # swiglu | gelu
    qk_norm: bool = False
    pos: str = "rope"                 # rope | sinusoidal | none
    rope_theta: float = 1e4
    rope_fraction: float = 1.0        # stablelm-2 uses 0.25
    use_bias: bool = False
    tie_embeddings: bool = False
    logits_softcap: float = 0.0

    # enc-dec / frontends
    encoder_layers: int = 0           # whisper: encoder depth
    frontend: Optional[str] = None    # "siglip_stub" | "conv_stub"
    n_prefix_tokens: int = 0          # vlm: image tokens; audio: frame count

    # ssm (rwkv6) / hybrid (rg-lru)
    rnn_head_dim: int = 64
    lru_width: Optional[int] = None

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"  # adam moments; grok uses bfloat16 to fit
    remat: bool = True
    scan_layers: bool = True          # False: unroll (dry-run cost analysis)

    # distribution
    microbatches: int = 1             # gradient-accumulation microbatches

    source: str = ""                  # provenance tag from the assignment

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> tuple:
        if self.block_pattern is None:
            return ("attn",) * self.n_layers
        reps = (self.n_layers + len(self.block_pattern) - 1) // len(self.block_pattern)
        return (self.block_pattern * reps)[: self.n_layers]

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS and memory budgeting."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hq = self.n_heads * self.hd
        hkv = self.n_kv_heads * self.hd
        total = V * d * (1 if self.tie_embeddings else 2)
        for kind in self.pattern:
            if kind in ("attn", "attn_local"):
                total += d * hq + 2 * d * hkv + hq * d       # qkv + out
            elif kind == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + 3 * w                    # in/out proj + gates (approx)
            elif kind == "rwkv":
                total += 5 * d * d + 2 * d                    # r,k,v,g,o (+ decay lora, small)
            if kind != "rwkv" and self.moe is not None:
                total += self.moe.n_experts * 3 * d * ff + d * self.moe.n_experts
            elif kind == "rwkv":
                total += 2 * d * ff                           # rwkv channel-mix (k,v)
            else:
                total += (3 if self.mlp == "swiglu" else 2) * d * ff
        if self.encoder_layers:
            total += self.encoder_layers * (4 * d * d + (3 if self.mlp == "swiglu" else 2) * d * ff)
            total += self.n_layers * (4 * d * d)              # cross-attention
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        dense = self.n_params() - self.n_layers * self.moe.n_experts * 3 * d * ff
        active = self.n_layers * self.moe.experts_per_token * 3 * d * ff
        return int(dense + active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid")
        if not sub_quadratic:
            return False, "pure full-attention arch: long_500k skipped per assignment"
    return True, ""
