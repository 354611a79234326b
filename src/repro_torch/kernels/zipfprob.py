"""The Zipf probability sums of the paper's §3 analysis (Figs 8 and 10).

A CUDA tensor goes to the hand-written kernel in ``csrc/zipfprob.cu``, which
evaluates a whole batch of points over one pmf in one launch; a CPU tensor
goes to the plain PyTorch version in `ref`. There is no fallback from one to
the other. ``launches`` counts the kernel's launches and ``points`` the
points those launches evaluated.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import zipf_bit_sums_batch_ref
from .segsel import check_tensors

launches = {"zipf_bit_sums": 0}
points = {"zipf_bit_sums": 0}

MAX_POINTS = 256        # points in one batch; the scratch holds 4 floats per point and block
_P = ctypes.c_void_p
_GRID = ("chunk", "blocks", "threads", "group")
_SIGNATURES = {
    "zipf_bit_sums_grid": [ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)],
    "zipf_bit_sums_batch_launch": [_P, ctypes.c_longlong, _P, ctypes.c_int, _P, _P, _P, _P]}
# (device, stream) -> (float32 scratch, int32 ticket that each launch leaves
# 0); a scratch outgrown is kept, not freed, as a captured graph may hold it
_buffers: dict = {}
_outgrown: list = []


def batch_grid(n: int) -> dict:
    """The kernel's launch shape for an (n,) pmf, as its C side chooses it:
    ``chunk`` pmf elements per block, ``blocks``, ``threads`` per block and
    ``group``, the points between two block reductions. Depends on n alone.
    Builds the kernel library."""
    lib = build.library("zipfprob", _SIGNATURES)
    grid = (ctypes.c_longlong * len(_GRID))()
    if lib.zipf_bit_sums_grid(n, grid) != 0:
        raise ValueError(f"no zipf_bit_sums grid for n={n}")
    return dict(zip(_GRID, grid))


def _exponents(exps, device: torch.device) -> torch.Tensor:
    """``exps`` (a sequence of (u0, v0, g0, r0) or a (P, 4) tensor) as a
    contiguous (P, 4) float32 tensor on ``device``; a host copy goes up
    without waiting for the device."""
    if isinstance(exps, torch.Tensor):
        e = exps.to(torch.float32)
    else:
        e = torch.tensor([[float(x) for x in row] for row in exps], dtype=torch.float32)
        e = e.reshape(-1, 4) if e.numel() == 0 else e
    if e.dim() != 2 or e.shape[1] != 4:
        raise ValueError(f"exps must be (P, 4) exponents (u0, v0, g0, r0), got shape "
                         f"{tuple(e.shape)}")
    if e.shape[0] > MAX_POINTS:
        raise ValueError(f"{e.shape[0]} points in one batch; at most {MAX_POINTS}")
    return e.to(device, non_blocking=device.type == "cuda").contiguous()


def _scratch(device: torch.device, stream: int, blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The scratch and ticket of launches on ``stream``, which run in order:
    a ticket zeroed once when made, and a scratch of at least `MAX_POINTS`
    points' partials over ``blocks`` blocks. One that is too small is
    replaced and kept alive."""
    key = (device, stream)
    scratch, ticket = _buffers.get(key, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    size = 4 * MAX_POINTS * blocks
    if scratch is None or scratch.numel() < size:
        if scratch is not None:
            _outgrown.append(scratch)
        scratch = torch.empty(size, dtype=torch.float32, device=device)
    _buffers[key] = (scratch, ticket)
    return scratch, ticket


def zipf_bit_sums_batch(probs, exps):
    """The four sums for each point (u0, v0, g0, r0) of ``exps`` over a
    contiguous (n,) float32 pmf ``probs``, the exponents rounded to float32:
    (P, 4) float32 rows [Σp(1-(1-p)^u0)(1-(1-p)^v0), Σp(1-(1-p)^v0),
    Σp(1-p)^g0, Σp((1-p)^g0 - (1-p)^(g0+r0))], at most `MAX_POINTS` points.
    On the card one launch evaluates the batch, each row bit-equal to the
    point launched alone and a repeat bit-identical. A p of 1 or more gives
    what the plain version gives there: a zero exponent makes its sums NaN
    (exp(0 * log1p(-1)))."""
    if not isinstance(probs, torch.Tensor) or probs.dim() != 1:
        raise ValueError("probs must be a 1-D tensor")
    device = check_tensors({"probs": probs}, tuple(probs.shape), torch.float32)
    e = _exponents(exps, device)
    n_points = e.shape[0]
    if device.type == "cpu":
        return zipf_bit_sums_batch_ref(probs, e)
    out = torch.empty(n_points, 4, dtype=torch.float32, device=device)
    if n_points == 0:
        return out
    n = probs.numel()
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch, ticket = _scratch(device, stream, batch_grid(n)["blocks"])
    lib = build.library("zipfprob", _SIGNATURES)
    with torch.cuda.device(device):
        err = lib.zipf_bit_sums_batch_launch(probs.data_ptr(), n, e.data_ptr(), n_points,
                                             scratch.data_ptr(), ticket.data_ptr(),
                                             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"zipfprob kernel launch failed with CUDA error {err}")
    launches["zipf_bit_sums"] += 1
    points["zipf_bit_sums"] += n_points
    return out


def zipf_bit_sums(probs, u0, v0, g0, r0):
    """The four sums at one point: `zipf_bit_sums_batch` of one, (4,)
    float32."""
    return zipf_bit_sums_batch(probs, [(u0, v0, g0, r0)])[0]


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
