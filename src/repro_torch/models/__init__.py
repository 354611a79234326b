"""Model zoo of the port: the decoder LM (dense, MoE, hybrid, SSM) behind the reference's facade."""
from .zoo import Model, build_model

__all__ = ["Model", "build_model"]
