"""Model zoo of the port: the dense decoder LM behind the reference's facade."""
from .zoo import Model, build_model

__all__ = ["Model", "build_model"]
