"""Carry configurations and states between the JAX package and the port.

Both directions go through plain values and numpy arrays, so the port needs
no JAX import: the JAX side hands over ``dataclasses.asdict(cfg)`` and
``jax.device_get(state)``. This is how a replay can start on one engine and
finish on the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.config import TorchSimConfig

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
