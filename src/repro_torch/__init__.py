"""PyTorch / CUDA port of the log-structured placement simulator.

A fleet of block traces is replayed through log-structured volumes and write
amplification comes out, as in the JAX package, whose results this port
matches bit for bit. On CUDA tensors the whole replay is one hand-written
CUDA kernel for Hopper (``kernels/csrc/replay.cu``, with the GC victim
argmax and the GC class assignment inside); ``engine="step"`` runs the step
engine instead, PyTorch ops per step around the victim-argmax and
class-assignment kernels. On CPU tensors the plain PyTorch versions run.

Entry points run on the card unless the caller passes ``device="cpu"``; they
raise when CUDA is missing and the CPU was not asked for.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device to run on: ``"cuda"`` unless told otherwise, and an error
    (never a quiet switch to the CPU) when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


from .core.config import TorchSimConfig, default_policy, init_state  # noqa: E402
from .core.torchsim import run, run_fleet, simulate, simulate_fleet  # noqa: E402

__all__ = ["TorchSimConfig", "default_policy", "init_state", "resolve_device", "run",
           "run_fleet", "simulate", "simulate_fleet"]
