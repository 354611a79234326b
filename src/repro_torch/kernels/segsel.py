"""GC victim selection: the Greedy / Cost-Benefit argmax over segment metadata.

A CUDA tensor goes to the hand-written kernel in ``csrc/segsel.cu``; a CPU
tensor goes to the plain PyTorch version in `ref`. There is no fallback from
one to the other. ``launches`` counts the kernel's launches per entry point.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import segment_select_batch_ref, segment_select_ref

launches = {"segment_select_batch": 0, "segment_select": 0}

_P = ctypes.c_void_p
_SIGNATURES = {"segsel_launch": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P]}


def check_tensors(arrays: dict, shape: tuple, dtype=torch.int32) -> torch.device:
    """Raise unless every named array is a contiguous tensor of ``dtype`` and
    ``shape`` on one CPU or CUDA device; return that device."""
    device = None
    for name, x in arrays.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device is None:
            device = x.device
        elif x.device != device:
            raise ValueError(f"{name} is on {x.device}, the others on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _launch(entry, seg_n, seg_nvalid, seg_stime, seg_state, t, selector_ids):
    V, S = seg_n.shape
    idx = torch.empty(V, dtype=torch.int32, device=seg_n.device)
    score = torch.empty(V, dtype=torch.float32, device=seg_n.device)
    lib = build.library("segsel", _SIGNATURES)
    stream = torch.cuda.current_stream(seg_n.device).cuda_stream
    with torch.cuda.device(seg_n.device):
        err = lib.segsel_launch(seg_n.data_ptr(), seg_nvalid.data_ptr(), seg_stime.data_ptr(),
                                seg_state.data_ptr(), t.data_ptr(), selector_ids.data_ptr(),
                                V, S, idx.data_ptr(), score.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segsel kernel launch failed with CUDA error {err}")
    launches[entry] += 1
    return idx, score


def segment_select_batch(seg_n, seg_nvalid, seg_stime, seg_state, t, selector_ids):
    """Victim argmax for a fleet: (V, S) int32 ``seg_n`` / ``seg_nvalid`` /
    ``seg_stime`` / ``seg_state``, (V,) int32 clocks ``t`` and selector ids
    (0 greedy, 1 cost-benefit). Returns ((V,) int32 idx, (V,) float32
    score); idx is -1 where no segment is eligible, ties go to the lowest
    index."""
    if seg_n.dim() != 2:
        raise ValueError(f"seg_n must be (V, S), got shape {tuple(seg_n.shape)}")
    V, S = seg_n.shape
    device = check_tensors({"seg_n": seg_n, "seg_nvalid": seg_nvalid, "seg_stime": seg_stime,
                            "seg_state": seg_state}, (V, S))
    if check_tensors({"t": t, "selector_ids": selector_ids}, (V,)) != device:
        raise ValueError("t and selector_ids must be on the segment arrays' device")
    if device.type == "cpu":
        return segment_select_batch_ref(seg_n, seg_nvalid, seg_stime, seg_state, t,
                                        selector_ids)
    return _launch("segment_select_batch", seg_n, seg_nvalid, seg_stime, seg_state, t,
                   selector_ids)


def segment_select(seg_n, seg_nvalid, seg_stime, seg_state, t, selector_id):
    """Victim argmax for one volume: (S,) int32 arrays, a clock ``t`` and a
    selector id (Python ints or 0-d int32 tensors on the arrays' device).
    Returns (0-d int32 idx, 0-d float32 score); the kernel runs as a launch
    with one volume."""
    if seg_n.dim() != 1:
        raise ValueError(f"seg_n must be (S,), got shape {tuple(seg_n.shape)}")
    (S,) = seg_n.shape
    device = check_tensors({"seg_n": seg_n, "seg_nvalid": seg_nvalid, "seg_stime": seg_stime,
                            "seg_state": seg_state}, (S,))
    t, sel = (x if isinstance(x, torch.Tensor)
              else torch.tensor(int(x), dtype=torch.int32, device=device)
              for x in (t, selector_id))
    if check_tensors({"t": t, "selector_id": sel}, ()) != device:
        raise ValueError("t and selector_id must be on the segment arrays' device")
    if device.type == "cpu":
        return segment_select_ref(seg_n, seg_nvalid, seg_stime, seg_state, t, sel)
    idx, score = _launch("segment_select", seg_n[None], seg_nvalid[None], seg_stime[None],
                         seg_state[None], t.reshape(1), sel.reshape(1))
    return idx[0], score[0]
