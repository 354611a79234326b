"""Carry configurations, states and LM parameters between the JAX package
and the port.

Both directions go through plain values and numpy arrays, so the port needs
no JAX import: the JAX side hands over ``dataclasses.asdict(cfg)``,
``jax.device_get(state)`` or ``jax.device_get(params)``. This is how a replay
can start on one engine and finish on the other, and how the tests give both
packages' models the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.config import TorchSimConfig
from .models.common import ParamSpec
from .models.transformer import lm_specs

# JaxSimConfig fields with no meaning on the port: the tensors' device
# decides whether a kernel or its plain version runs
JAX_ONLY_FIELDS = ("use_kernels", "kernels_interpret")


def config_from_jax(jax_cfg_fields: dict) -> TorchSimConfig:
    """The port's config from a JAX config's fields (``dataclasses.asdict``)."""
    return TorchSimConfig(**{k: v for k, v in jax_cfg_fields.items()
                             if k not in JAX_ONLY_FIELDS})


def state_from_numpy(np_state: dict, device) -> dict:
    """The port's state from a JAX state given as numpy arrays, one volume
    (no leading axis) or a fleet (leading volume axis), the stateful schemes'
    ``sch_*`` slices included."""
    batched = np.ndim(np_state["t"]) == 1
    out = {}
    for key, x in np_state.items():
        x = np.array(x, copy=True)
        out[key] = torch.from_numpy(x if batched else x[None]).to(device)
    return out


def state_to_numpy(state: dict) -> dict:
    """The state as numpy arrays, leading volume axis kept."""
    return {key: x.detach().cpu().numpy() for key, x in state.items()}


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor, bfloat16 (numpy's ``ml_dtypes`` type) bit
    for bit."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def lm_params_from_numpy(cfg, tree, device) -> dict:
    """The port's LM parameters from a JAX params pytree given as numpy
    arrays (``jax.device_get(params)``): the same nested dicts and lists,
    the stacked ``blocks/p<i>_<kind>`` tensors kept stacked (the port slices
    a layer as JAX's scan does). Raises unless every leaf of
    ``lm_specs(cfg)`` is there with its shape, and nothing else."""
    def take(spec, x, path):
        if isinstance(spec, ParamSpec):
            if tuple(np.shape(x)) != spec.shape:
                raise ValueError(f"{path}: shape {np.shape(x)}, expected {spec.shape}")
            return _tensor(np.asarray(x), device)
        if isinstance(spec, dict):
            if not isinstance(x, dict) or set(x) != set(spec):
                raise ValueError(f"{path}: keys {sorted(x) if isinstance(x, dict) else x!r}, "
                                 f"expected {sorted(spec)}")
            return {k: take(spec[k], x[k], f"{path}/{k}") for k in spec}
        if len(x) != len(spec):
            raise ValueError(f"{path}: {len(x)} entries, expected {len(spec)}")
        return [take(s, v, f"{path}[{i}]") for i, (s, v) in enumerate(zip(spec, x))]
    return take(lm_specs(cfg), tree, "params")
