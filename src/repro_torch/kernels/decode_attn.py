"""Single-token GQA decode attention (flash-decode).

A CUDA tensor goes to the hand-written kernel in ``csrc/decode_attn.cu``; a
CPU tensor goes to the plain PyTorch version in `ref`. There is no fallback
from one to the other. ``launches`` counts the kernel's launches. No model of
the port calls this; like the JAX package's kernel, its entry point is
`flash_decode` itself.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import flash_decode_ref
from .segsel import check_tensors

launches = {"flash_decode": 0}

HEAD_DIMS = (64, 96, 128)       # D the kernel takes (tested on the card)
MAX_GROUP = 64                  # query heads per KV head; bounds its shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"flash_decode_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                                       _P, _P]}


def _check_shapes(q, k, v, kv_len) -> torch.device:
    """Raise unless the layouts, dtypes and sizes are what the kernel takes;
    return the tensors' device. Reads no tensor data."""
    for name, x in (("q", q), ("k", k), ("v", v), ("kv_len", kv_len)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B, Hq, D) and k (B, S, Hkv, D), got shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if B < 1 or S < 1 or Hkv < 1 or Hq % Hkv != 0:
        raise ValueError(f"need B, S, Hkv >= 1 and Hq % Hkv == 0, got B={B} S={S} Hq={Hq} "
                         f"Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel takes {HEAD_DIMS}")
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{Hq // Hkv} query heads per KV head; at most {MAX_GROUP}")
    device = check_tensors({"q": q}, (B, Hq, D), q.dtype)
    if (check_tensors({"k": k, "v": v}, (B, S, Hkv, D), q.dtype) != device
            or check_tensors({"kv_len": kv_len}, (B,)) != device):
        raise ValueError("q, k, v and kv_len must be on one device")
    return device


def flash_decode(q, k, v, kv_len):
    """Decode attention of one query token per batch row: q (B, Hq, D) over
    k and v (B, S, Hkv, D), the G = Hq / Hkv query heads of a KV head sharing
    its rows, positions >= ``kv_len`` (B,) int32 masked. Returns (B, Hq, D)
    in q's dtype. Takes float32 or bfloat16 (one dtype for q, k and v), D in
    `HEAD_DIMS` and G <= `MAX_GROUP`, all contiguous. Every ``kv_len`` must
    be at least 1 (one read of it from the device; an empty history has no
    softmax) and raises otherwise; a length above S counts as S."""
    device = _check_shapes(q, k, v, kv_len)
    if int(kv_len.min()) < 1:
        raise ValueError("every kv_len must be >= 1")
    if device.type == "cpu":
        return flash_decode_ref(q, k, v, kv_len)
    return _launch(q, k, v, kv_len)


def _launch(q, k, v, kv_len):
    """The kernel on tensors that passed `flash_decode`'s checks, with no
    read of the device (so that a CUDA graph can capture it)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    out = torch.empty_like(q)
    lib = build.library("decode_attn", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_decode_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      kv_len.data_ptr(), B, S, Hkv, Hq // Hkv, D,
                                      _DTYPES[q.dtype], 1.0 / (D ** 0.5), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed with CUDA error {err}")
    launches["flash_decode"] += 1
    return out
