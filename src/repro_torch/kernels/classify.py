"""Placement-class assignment for a batch of blocks (the elementwise schemes).

A CUDA tensor goes to the hand-written kernel in ``csrc/classify.cu``; a CPU
tensor goes to the plain PyTorch version in `ref`. There is no fallback from
one to the other. ``launches`` counts the kernel's launches per call site:
``gc`` for a GC rewrite's live blocks (the TPU kernel's only call site) and
``user`` for the user write's (V, 1) batch, which the JAX engine classifies
with plain jnp instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import classify_ref
from .segsel import check_tensors

launches = {"classify_gc": 0, "classify_user": 0}

_P = ctypes.c_void_p
_SIGNATURES = {"classify_launch": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P]}


def classify(v, g, from_c1, is_gc, ell, scheme_ids, site="gc"):
    """Class ids of (V, B) blocks: int32 ``v`` (predecessor lifespan), ``g``
    (age), ``from_c1`` and ``is_gc`` flags; per-row float32 ``ell`` (V,) and
    int32 dense ``scheme_ids`` (V,). Only the elementwise ids (nosep 0,
    sepgc 1, sepbit 2, uw 7, gw 8) give classes other than 0. ``site``
    (``"gc"`` or ``"user"``) names the launch counter."""
    counter = f"classify_{site}"
    if counter not in launches:
        raise ValueError(f"site must be 'gc' or 'user', got {site!r}")
    if v.dim() != 2:
        raise ValueError(f"v must be (V, B), got shape {tuple(v.shape)}")
    V, B = v.shape
    device = check_tensors({"v": v, "g": g, "from_c1": from_c1, "is_gc": is_gc}, (V, B))
    if (check_tensors({"ell": ell}, (V,), torch.float32) != device
            or check_tensors({"scheme_ids": scheme_ids}, (V,)) != device):
        raise ValueError("ell and scheme_ids must be on the blocks' device")
    if device.type == "cpu":
        return classify_ref(v, g, from_c1, is_gc, ell, scheme_ids)
    out = torch.empty((V, B), dtype=torch.int32, device=device)
    lib = build.library("classify", _SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.classify_launch(v.data_ptr(), g.data_ptr(), from_c1.data_ptr(),
                                  is_gc.data_ptr(), ell.data_ptr(), scheme_ids.data_ptr(),
                                  V, B, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"classify kernel launch failed with CUDA error {err}")
    launches[counter] += 1
    return out
