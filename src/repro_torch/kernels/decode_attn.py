"""Single-token GQA decode attention (flash-decode).

A CUDA tensor goes to the hand-written kernel in ``csrc/decode_attn.cu``; a
CPU tensor goes to the plain PyTorch version in `ref`. There is no fallback
from one to the other. ``launches`` counts the kernel's launches. The kernel
takes D in `HEAD_DIMS` and at most `MAX_GROUP` query heads per KV head; the
plain version takes any. The model's decode step (`models.common.
decode_attend`) calls `flash_decode_unread`, once per layer and token: its
``kv_len = pos + 1`` is at least 1 by construction, so that entry reads
nothing from the device. `flash_decode` checks the lengths with one read.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import flash_decode_ref
from .segsel import check_tensors

launches = {"flash_decode": 0}

HEAD_DIMS = (64, 96, 128, 256)  # D the kernel takes (tested on the card)
MAX_GROUP = 64                  # query heads per KV head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_GRID = ("chunk", "chunks", "tile", "tiles", "threads", "scratch")
_SIGNATURES = {
    "flash_decode_grid": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)],
    "flash_decode_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                            _P, _P, _P]}


def split_grid(B: int, S: int, Hq: int, Hkv: int, D: int) -> dict:
    """The kernel's launch shape, as its C side chooses it: ``chunk`` KV rows
    per split block and ``chunks`` blocks along S, ``tile`` query heads per
    block and ``tiles`` per KV head, ``threads`` per block, and ``scratch``,
    the float32 values of the split pass's partials. Sized from S alone, so
    the launch reads nothing from the device. Builds the kernel library."""
    lib = build.library("decode_attn", _SIGNATURES)
    grid = (ctypes.c_longlong * len(_GRID))()
    if lib.flash_decode_grid(B, S, Hkv, Hq // Hkv, D, grid) != 0:
        raise ValueError(f"no flash_decode grid for B={B} S={S} Hq={Hq} Hkv={Hkv} D={D}")
    return dict(zip(_GRID, grid))


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
    device = check_tensors({"q": q}, (B, Hq, D), q.dtype)
    if (check_tensors({"k": k, "v": v}, (B, S, Hkv, D), q.dtype) != device
            or check_tensors({"kv_len": kv_len}, (B,)) != device):
        raise ValueError("q, k, v and kv_len must be on one device")
    if device.type == "cuda":
        check_kernel_shape(Hq, Hkv, D)
    return device


def check_kernel_shape(Hq: int, Hkv: int, D: int) -> None:
    """Raise unless the kernel takes head dim ``D`` and ``Hq / Hkv`` query
    heads per KV head (the plain version takes any)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel takes {HEAD_DIMS}")
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{Hq // Hkv} query heads per KV head; at most {MAX_GROUP}")


def flash_decode(q, k, v, kv_len):
    """Decode attention of one query token per batch row: q (B, Hq, D) over
    k and v (B, S, Hkv, D), the G = Hq / Hkv query heads of a KV head sharing
    its rows, positions >= ``kv_len`` (B,) int32 masked. Returns (B, Hq, D)
    in q's dtype. Takes float32 or bfloat16 (one dtype for q, k and v), D in
    `HEAD_DIMS` and G <= `MAX_GROUP` on CUDA (any on the CPU), all
    contiguous. Every ``kv_len`` must be at least 1 (one read of it from the
    device; an empty history has no softmax) and raises otherwise; a length
    above S counts as S."""
    _check_shapes(q, k, v, kv_len)
    if int(kv_len.min()) < 1:
        raise ValueError("every kv_len must be >= 1")
    return flash_decode_unread(q, k, v, kv_len)


def flash_decode_unread(q, k, v, kv_len):
    """`flash_decode` for a caller whose every ``kv_len`` is at least 1 by
    construction, as the decode step's ``pos + 1``: the same checks of
    layouts, dtypes and sizes, and no read of the device, so a decode loop
    never waits for the card."""
    if _check_shapes(q, k, v, kv_len).type == "cpu":
        return flash_decode_ref(q, k, v, kv_len)
    return _launch(q, k, v, kv_len)


def _launch(q, k, v, kv_len):
    """The kernel on tensors that passed `flash_decode`'s checks, with no
    read of the device (so that a CUDA graph can capture it). The split
    pass's partials go to float32 scratch from `torch.empty`."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel's "
                             "vector loads)")
    part = torch.empty(split_grid(B, S, Hq, Hkv, D)["scratch"], dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    lib = build.library("decode_attn", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_decode_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      kv_len.data_ptr(), B, S, Hkv, Hq // Hkv, D,
                                      _DTYPES[q.dtype], 1.0 / (D ** 0.5), part.data_ptr(),
                                      out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed with CUDA error {err}")
    launches["flash_decode"] += 1
    return out
