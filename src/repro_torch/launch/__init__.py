from .mesh import make_host_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_host_mesh"]
