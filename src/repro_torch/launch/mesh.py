"""Mesh construction, the twin of the JAX package's ``launch/mesh.py``.

Single pod: 256 chips as (data=16, model=16). Multi-pod: 2 pods = 512 chips
as (pod=2, data=16, model=16); the pod axis extends data parallelism and
crosses the slow links, so only gradient reductions (and the optional
compressed collectives) traverse it. The production meshes exist only as
plans here, so `make_production_mesh` returns a shape-only mesh
(`ShapeMesh`); the dry run lays it over a fake process group.
`make_host_mesh` builds a real DeviceMesh over the ranks of the initialized
default process group.
"""

from __future__ import annotations

from ..distributed.sharding import ShapeMesh


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShapeMesh(axes, shape)


def make_host_mesh(model_axis: int = 1):
    """A (data, model) DeviceMesh over the ranks of the default process group
    (model axis ``min(model_axis, world)``), on CUDA when that group is
    NCCL, else on the CPU. Raises when no group is initialized: it creates
    none behind the caller's back."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    model_axis = min(model_axis, n)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
