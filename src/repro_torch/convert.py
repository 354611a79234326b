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
from .models.common import ParamSpec, tree_map
from .models.zoo import build_model

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


# process-wide: the bytes of state `state_to_numpy` handed to the host, read
# through `kernels.ops.host_counts`, zeroed by `reset_launch_counts`
readback = {"state_readback_bytes": 0}


def state_to_numpy(state: dict) -> dict:
    """The state as numpy arrays, leading volume axis kept; adds their bytes
    to ``readback`` (on every device: on the CPU the arrays share the
    tensors' memory)."""
    out = {key: x.detach().cpu().numpy() for key, x in state.items()}
    readback["state_readback_bytes"] += sum(x.nbytes for x in out.values())
    return out


def _tensor(x: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array as a tensor, bfloat16 (numpy's ``ml_dtypes`` type, or
    uint16 bits where ``dtype`` is bfloat16) bit for bit. Raises where
    ``dtype`` is given and the array holds another."""
    if x.dtype.name == "bfloat16" or (dtype == torch.bfloat16 and x.dtype == np.uint16):
        t = torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(x, copy=True))
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"dtype {x.dtype}, expected {dtype}")
    return t.to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy, a bfloat16 one as its uint16 bits
    (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def lm_params_from_numpy(cfg, tree, device, dtype: torch.dtype | None = None) -> dict:
    """The port's LM parameters from a JAX params pytree given as numpy
    arrays (``jax.device_get(params)``): the same nested dicts and lists,
    the stacked ``blocks/p<i>_<kind>`` tensors kept stacked (the port slices
    a layer as JAX's scan does). Raises unless every leaf of the model's
    ``param_specs()`` (the decoder LM's tree, with ``vision_proj`` for the
    vlm family; whisper's for the audio family) is there with its shape, and
    nothing else, and, where ``dtype`` is given, in that dtype (bfloat16 may
    come as uint16 bits)."""
    def take(spec, x, path):
        if isinstance(spec, ParamSpec):
            if tuple(np.shape(x)) != spec.shape:
                raise ValueError(f"{path}: shape {np.shape(x)}, expected {spec.shape}")
            try:
                return _tensor(np.asarray(x), device, dtype)
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from None
        if isinstance(spec, dict):
            if not isinstance(x, dict) or set(x) != set(spec):
                raise ValueError(f"{path}: keys {sorted(x) if isinstance(x, dict) else x!r}, "
                                 f"expected {sorted(spec)}")
            return {k: take(spec[k], x[k], f"{path}/{k}") for k in spec}
        if len(x) != len(spec):
            raise ValueError(f"{path}: {len(x)} entries, expected {len(spec)}")
        return [take(s, v, f"{path}[{i}]") for i, (s, v) in enumerate(zip(spec, x))]
    return take(build_model(cfg).param_specs(), tree, "params")


def train_state_from_numpy(cfg, opt_cfg, tree, device) -> dict:
    """The port's train state from a JAX one given as numpy arrays
    (``jax.device_get(state)`` of ``{"params", "opt": {"m", "v", "step"}}``):
    the params in ``cfg.pdtype()`` and the moments in ``opt_cfg.state_dtype``
    by `lm_params_from_numpy`, the step a 0-d int32 tensor."""
    sd = getattr(torch, opt_cfg.state_dtype)
    opt = tree["opt"]
    return {"params": lm_params_from_numpy(cfg, tree["params"], device, cfg.pdtype()),
            "opt": {"m": lm_params_from_numpy(cfg, opt["m"], device, sd),
                    "v": lm_params_from_numpy(cfg, opt["v"], device, sd),
                    "step": _tensor(np.asarray(opt["step"]), device, torch.int32)}}


def train_state_to_numpy(state) -> dict:
    """The inverse of `train_state_from_numpy`: every leaf as numpy on the
    host, the same nesting, a bfloat16 leaf as its uint16 bits."""
    return tree_map(_numpy, state)
