"""The shared classifiers of the temperature schemes (eti, mq, sfr, fadac,
warcip) on torch tensors.

A twin of the JAX package's ``placement/temperature_shared.py``, whose
functions the numpy and JAX backends both run verbatim. That module calls
``.astype`` and wraps its constants in ``np.float32``, so it cannot take
torch tensors; this one keeps its constants, its formulas and their order of
operations (left to right, one rounding per float32 op), so each function
gives the reference's bits. Every function takes a leading volume axis; the
reductions (`eti_user_class`'s mean, `warcip_assign`'s first minimum) run
over each volume's own entries. ``tests/test_torch_schemes.py`` holds each
function bit-equal to the numpy module on random inputs.

Two rules keep the bits on CUDA as well as on the CPU: eager ops round once
each (no fused multiply-add), and no float32 tensor is divided by a Python
number (CUDA multiplies by the reciprocal then), so every quotient here has
a tensor on both sides (`_const`).
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
I32 = torch.int32
LN2 = float(np.float32(0.6931471805599453))

ETI_EXTENT_BLOCKS = 256
ETI_DECAY_EVERY = 1 << 15
MQ_USER_CLASSES = 5
SFR_CHUNK_BLOCKS = 64
SFR_LAST_INIT = -(2 ** 30)        # "never written" chunk timestamp
FADAC_CHUNK_BLOCKS = 64
FADAC_HALF_LIFE = 1 << 16
WARCIP_CENTROID_INIT = (2.0, 6.0, 10.0, 14.0, 18.0)
WARCIP_COUNT_CAP = 1024.0

_CONSTS: dict = {}


def _const(values, like: torch.Tensor, dtype=F32) -> torch.Tensor:
    """``values`` (a number or a tuple) as a tensor on ``like``'s device,
    made once per device: a device tensor made from a host value costs a
    copy each time."""
    key = (like.device, dtype, values)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=dtype, device=like.device)
    return _CONSTS[key]


def _f32(c: float) -> float:
    """A Python float holding the float32 value of ``c``."""
    return float(np.float32(c))


def _ladder(x, thresholds: tuple) -> torch.Tensor:
    """The number of ``thresholds`` that ``x`` reaches, as int32: the
    reference's sum of comparisons (an integer sum, so its order is free)."""
    return (x.unsqueeze(-1) >= _const(thresholds, x, x.dtype)).sum(-1, dtype=I32)


_POW2 = tuple(1 << k for k in range(1, 31))


def ilog2(x):
    """``floor(log2(x))`` for integer ``x >= 1``, 0 below: the count of the
    powers 2^1 .. 2^30 that ``x`` reaches."""
    return _ladder(x, _POW2)


def log2_interp(x):
    """Piecewise-linear ``log2(x)`` for integer ``x >= 1``: ``f + x/2^f - 1``
    (the quotient is exact, a power of two)."""
    f = ilog2(x)
    pow2 = (torch.ones_like(x) << f).to(F32)
    return f.to(F32) + x.to(F32) / pow2 - 1.0


# -- eti: per-extent counters, periodic halving --------------------------------

def eti_fold(count, last_epoch, epoch):
    """A lazily decayed counter brought forward to ``epoch``: one halving
    (integer floor) per elapsed epoch."""
    return count >> (epoch - last_epoch).clamp(0, 31)


def eti_user_class(counts, last_epochs, epoch, e):
    """Hot (0) or cold (1) user class of extent ``e`` (V,) from each volume's
    counters (V, n_ext) at ``epoch`` (V,): hot when its folded count
    exceeds ``max(mean, 1)``, the mean an integer sum over the volume's own
    extents converted once to float32."""
    temps = eti_fold(counts, last_epochs, epoch.unsqueeze(-1))
    mean = temps.sum(-1).to(F32) / _const(float(temps.shape[-1]), temps)
    thr = mean.clamp(min=1.0)
    mine = torch.gather(temps, -1, e.unsqueeze(-1).long()).squeeze(-1)
    hot = (mine.to(F32) > thr).to(I32)
    return (1 - hot).clamp(0, 2)


# -- mq: log2(freq) queue levels with expiry demotion --------------------------

def mq_ladder(freq):
    """``min(bit_length(freq) - 1, 4)`` for ``freq >= 1``."""
    return _ladder(freq, (2, 4, 8, 16))


def mq_user(freq_new, level_prev, expire_prev, t):
    """Class and new queue level of a user write (``freq_new`` already
    counts it); expiry strictly past ``expire_prev`` demotes one level
    before the frequency ladder promotes again."""
    demote = ((t > expire_prev) & (level_prev > 0)).to(I32)
    lvl = torch.maximum(mq_ladder(freq_new), level_prev - demote)
    cls = (4 - lvl).clamp(0, 5)
    return cls, lvl


# -- sfr: sequentiality / frequency / recency score ----------------------------

def sfr_freq_update(freq):
    """Per-chunk EWMA frequency: ``0.9 * freq + 1``."""
    return _f32(0.9) * freq + 1.0


def sfr_score(freq, dt, seq_f):
    """SFR score from the updated frequency, the recency delta ``dt >= 0``
    and sequentiality as float32 0/1."""
    ln = LN2 * log2_interp(dt + 1)
    rec = _const(1.0, ln) / (1.0 + ln)
    fnorm = (freq / _const(16.0, freq)).clamp(max=1.0)
    return _f32(0.4) * fnorm + _f32(0.4) * rec + _f32(0.2) * (1.0 - seq_f)


def sfr_class(score):
    """A non-negative score bucketed into user classes 4 (cold) .. 0 (hot)."""
    lvl = (score * 5.0).clamp(0.0, 4.0).to(I32)
    return (4 - lvl).clamp(0, 5)


# -- fadac: fading counters, lazy half-life decay ------------------------------

def fadac_fold(count, last, now, half_life=FADAC_HALF_LIFE):
    """Decay at read: one halving per whole half-life since the last update."""
    return count >> ((now - last).clamp(min=0) // half_life).clamp(0, 31)


def fadac_class(temp):
    """``5 - min(floor(log2(1 + temp)), 5)`` by the thresholds 1, 3, 7, 15, 31."""
    return (5 - _ladder(temp, (1, 3, 7, 15, 31))).clamp(0, 5)


# -- warcip: online k-means over log rewrite intervals -------------------------

def warcip_interval(dt):
    """Log-scale rewrite interval ``log2(max(dt, 1) + 1)``."""
    return log2_interp(dt.clamp(min=1) + 1)


def warcip_assign(centroids, li):
    """Each volume's nearest centroid (V, k) to ``li`` (V,), the first
    minimum on a tie, as int32."""
    return (centroids - li.unsqueeze(-1)).abs().argmin(-1).to(I32)


def warcip_update(cent_j, cnt_j, li):
    """Online k-means step of the assigned centroid; its count increments
    before the capped divisor. Returns ``(new_centroid, new_count)``."""
    c2 = cnt_j + 1.0
    return cent_j + (li - cent_j) / c2.clamp(max=WARCIP_COUNT_CAP), c2
