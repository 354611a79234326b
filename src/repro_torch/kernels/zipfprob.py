"""The Zipf probability sums of the paper's §3 analysis (Figs 8 and 10).

A CUDA tensor goes to the hand-written kernel in ``csrc/zipfprob.cu``; a CPU
tensor goes to the plain PyTorch version in `ref`. There is no fallback from
one to the other. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import zipf_bit_sums_ref
from .segsel import check_tensors

launches = {"zipf_bit_sums": 0}

_MAX_BLOCKS = 1024      # the first pass's grid, at most; its partials fill the scratch
_P = ctypes.c_void_p
_F = ctypes.c_float
_SIGNATURES = {"zipf_bit_sums_launch": [_P, ctypes.c_longlong, _F, _F, _F, _F, _P,
                                        ctypes.c_int, _P, _P]}


def zipf_bit_sums(probs, u0, v0, g0, r0):
    """The four sums over a contiguous (n,) float32 pmf ``probs``, with the
    exponents rounded to float32: (4,) float32 [Σp(1-(1-p)^u0)(1-(1-p)^v0),
    Σp(1-(1-p)^v0), Σp(1-p)^g0, Σp((1-p)^g0 - (1-p)^(g0+r0))]. On the card
    the order of the additions is fixed, so a repeat is bit-identical."""
    if not isinstance(probs, torch.Tensor) or probs.dim() != 1:
        raise ValueError("probs must be a 1-D tensor")
    device = check_tensors({"probs": probs}, tuple(probs.shape), torch.float32)
    exps = [float(x) for x in (u0, v0, g0, r0)]
    if device.type == "cpu":
        return zipf_bit_sums_ref(probs, *exps)
    out = torch.empty(4, dtype=torch.float32, device=device)
    partial = torch.empty(4 * _MAX_BLOCKS, dtype=torch.float32, device=device)
    lib = build.library("zipfprob", _SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.zipf_bit_sums_launch(probs.data_ptr(), probs.numel(), *exps,
                                       partial.data_ptr(), _MAX_BLOCKS, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"zipfprob kernel launch failed with CUDA error {err}")
    launches["zipf_bit_sums"] += 1
    return out


def pr_user_bit_kernel(probs, u0, v0):
    """Pr(u <= u0 | v <= v0) as a float32 0-d tensor: sum 0 over
    max(sum 1, 1e-30)."""
    s = zipf_bit_sums(probs, u0, v0, 0.0, 0.0)
    return s[0] / torch.clamp(s[1], min=1e-30)


def pr_gc_bit_kernel(probs, g0, r0):
    """Pr(u <= g0 + r0 | u >= g0) as a float32 0-d tensor: sum 3 over
    max(sum 2, 1e-30)."""
    s = zipf_bit_sums(probs, 0.0, 0.0, g0, r0)
    return s[3] / torch.clamp(s[2], min=1e-30)
