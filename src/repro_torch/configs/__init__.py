"""Per-architecture configs (exact assigned dimensions) + registry: copies of
the JAX package's ``configs/``, held equal to them by the tests."""
from .base import ArchConfig, MoEConfig, SHAPES, ShapeConfig, shape_applicable
from .registry import ARCH_IDS, get_config, smoke_config

__all__ = ["SHAPES", "ArchConfig", "MoEConfig", "ShapeConfig",
           "shape_applicable", "ARCH_IDS", "get_config", "smoke_config"]
