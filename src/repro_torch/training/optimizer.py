"""AdamW of the port, with per-arch state dtypes and LR schedules: the twin of
the JAX package's ``training/optimizer.py``.

Moments are kept in ``state_dtype``; updates are computed in float32 and
cast back to each parameter's dtype. The step count, the learning rate, the
clip scale and the bias corrections are 0-d tensors on the parameters'
device, computed in float32 as the reference computes them (a float32 power
of ``b1`` at ``step``), so a train step reads nothing from the device. Every
constant is a 0-d float32 tensor: on CUDA, PyTorch divides by a Python
number as a multiplication by its reciprocal, and computes ``number /
tensor`` as a reciprocal times the number, where the reference divides.

``adamw_update`` writes the parameters and moments in place (under
``torch.no_grad``), leaf by leaf, so that a stacked ``blocks/p<i>_<kind>``
leaf stays one tensor and its layer views keep working.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.common import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"          # cosine | linear | constant
    state_dtype: str = "float32"


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to float32, as a 0-d tensor on ``like``'s device
    (a fill: no copy from the host)."""
    return torch.full((), value, dtype=F32, device=like.device)


# glibc's cosf (the ARM optimized-routines algorithm), which the reference's
# XLA CPU program calls: [table 0, table 1] of (c0..c4, s1..s3) and the
# reduction's 2^24 * 2/pi and pi/2. Near the end of the cosine schedule
# 1 + cos(pi frac) cancels, so a cos one ulp off moves the rate by several.
_COSF_C = tuple(map(float.fromhex, ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                     "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")))
_COSF_S = tuple(map(float.fromhex, ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                     "-0x1.994eb3774cf24p-13")))
_HPI_INV, _HPI = float.fromhex("0x1.45f306dc9c883p+23"), float.fromhex("0x1.921fb54442d18p0")


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """float32 cos of ``y`` (|y| < 120) as glibc's ``cosf`` computes it: a
    reduction by pi/2 and a polynomial, both in float64, one rounding to
    float32 at the end."""
    x = y.to(torch.float64)
    bits = y.view(torch.int32) & 0x7FFFFFFF
    small = (bits >> 20) < (0x3F490FDB >> 20)               # abstop12(y) < abstop12(pi/4)
    n = torch.where(small, 0, ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24)
    x = x - n.to(torch.float64) * _HPI
    x = x * torch.where((n & 3 == 1) | (n & 3 == 2), -1.0, 1.0)
    x2 = x * x
    sin = x + (x * x2) * _COSF_S[0] + ((x * x2) * x2) * (_COSF_S[1] + x2 * _COSF_S[2])
    cos = ((_COSF_C[0] + x2 * _COSF_C[1]) + (x2 * x2) * _COSF_C[2]
           + ((x2 * x2) * x2) * (_COSF_C[3] + x2 * _COSF_C[4]))
    cos = torch.where(n & 2 == 2, -cos, cos)
    out = torch.where((n & 1) == 1, sin, cos).to(F32)
    return torch.where(bits < 0x39800000, 1.0, out)         # |y| < 2^-12


def lr_at(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (0-d int), a 0-d float32 tensor."""
    s = step.to(F32)
    warm = torch.minimum(s / _f32(max(c.warmup_steps, 1), s), _f32(1.0, s))
    lr = _f32(c.lr, s) * warm
    if c.schedule == "constant":
        return lr
    frac = torch.clamp((s - _f32(c.warmup_steps, s))
                       / _f32(max(c.total_steps - c.warmup_steps, 1), s), 0.0, 1.0)
    if c.schedule == "cosine":
        decay = _f32(0.5, s) * (_f32(1.0, s) + _cosf(_f32(math.pi, s) * frac))
    else:
        decay = _f32(1.0, s) - frac
    return lr * decay


def init_opt_state(c: AdamWConfig, params) -> dict:
    """Zero moments in ``c.state_dtype`` shaped as ``params``, and step 0 (a
    0-d int32 tensor on the parameters' device)."""
    dt = getattr(torch, c.state_dtype)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf: per leaf a sum of squares."""
    return torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(x.to(F32)))
                                             for x in tree_leaves(tree)])))


@torch.no_grad()
def adamw_update(c: AdamWConfig, params, grads, opt: dict):
    """One AdamW step; returns (params, new_opt, metrics). ``params`` and
    the moments in ``opt`` are updated in place; ``grads`` is a tree shaped
    as ``params`` (each leaf any float dtype)."""
    step = opt["step"] + 1
    gn = global_norm(grads)
    scale = (torch.minimum(_f32(1.0, gn), _f32(c.grad_clip, gn)
                           / torch.maximum(gn, _f32(1e-9, gn))) if c.grad_clip else None)
    lr = lr_at(c, step)
    s = step.to(F32)
    b1c = _f32(1.0, s) - torch.pow(_f32(c.b1, s), s)
    b2c = _f32(1.0, s) - torch.pow(_f32(c.b2, s), s)
    b1, b2, nb1, nb2 = (_f32(x, s) for x in (c.b1, c.b2, 1 - c.b1, 1 - c.b2))
    eps, wd = _f32(c.eps, s), _f32(c.weight_decay, s)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(opt["m"]),
                          tree_leaves(opt["v"])):
        g32 = g.to(F32)
        if scale is not None:
            g32 = g32 * scale
        m32 = b1 * m.to(F32) + nb1 * g32
        v32 = b2 * v.to(F32) + nb2 * g32 * g32
        del g32
        p32 = p.to(F32)
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + eps) + wd * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, {"m": opt["m"], "v": opt["v"], "step": step}, {"grad_norm": gn, "lr": lr}
