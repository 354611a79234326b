"""BIT-inference analysis under Zipf workloads (paper §3.2-§3.3).

The paper's Figures 8 and 10 in closed form, over the Zipf pmf p:

  Pr(u <= u0 | v <= v0)     = Σ p (1-(1-p)^u0)(1-(1-p)^v0) / Σ p (1-(1-p)^v0)
  Pr(u <= g0+r0 | u >= g0)  = Σ p ((1-p)^g0 - (1-p)^(g0+r0)) / Σ p (1-p)^g0

with (1-p)^e = exp(e * log1p(-p)). The sums come from the
`kernels.zipfprob.zipf_bit_sums_batch` kernel in float32 on the card (its
plain version on the CPU). Each figure builds its pmf on the device once
per alpha and evaluates all of that pmf's points in one batch: one launch
and one host read per pmf. Units follow the paper: 1 GiB = 2^18 4 KiB
blocks, and n = 10 * 2^18 (a 10 GiB working set).

Figures 9 and 11 are the same conditionals measured on a trace
(`trace_conditional_user`, `trace_conditional_gc`), vectorised on the
device: a stable sort by LBA pairs each write with the previous write of its
LBA. Their counts are integers, so they equal a per-write loop exactly.

Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..kernels.zipfprob import MAX_POINTS, zipf_bit_sums_batch

BLOCKS_PER_GIB = 2 ** 18
PAPER_N = 10 * BLOCKS_PER_GIB
# the figures' default windows in GiB and skews
FIG8_WINDOWS_GIB = (0.25, 0.5, 1, 2, 4)     # u0 and v0 of Fig 8(a), v0 of Fig 8(b)
FIG8B_U0_GIB = 1.0
FIG10_G0_GIB = (2, 4, 8, 16, 32)            # g0 of Figs 10(a) and 10(b)
FIG10A_R0_GIB = (1, 2, 4, 8)
FIG10B_R0_GIB = 8.0
FIG_ALPHAS = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)  # Figs 8(b) and 10(b)


def zipf_pmf(n: int, alpha: float, device="cuda") -> torch.Tensor:
    """The Zipf pmf over ranks 1..n, made on ``device`` in float64 as
    `traces.zipf_probs` makes it (1/i^alpha over the sum), then cast once
    to float32."""
    w = torch.arange(1, n + 1, dtype=torch.float64, device=resolve_device(device)).pow(-alpha)
    return (w / w.sum()).to(torch.float32)


def _pmf(probs, n, alpha, device) -> torch.Tensor:
    if probs is None:
        return zipf_pmf(n, alpha, device)
    return torch.as_tensor(probs).to(resolve_device(device)).to(torch.float32)


def _sums(probs, exps) -> list:
    """The kernel's four sums at each (u0, v0, g0, r0) of ``exps`` over
    ``probs``, as float rows: one launch and one host read for each
    `MAX_POINTS` points."""
    return [row for i in range(0, len(exps), MAX_POINTS)
            for row in zipf_bit_sums_batch(probs, exps[i:i + MAX_POINTS]).tolist()]


def _user_bits(probs, windows) -> list:
    """Pr(u <= u0 | v <= v0) at each (u0, v0) of ``windows``, in blocks."""
    sums = _sums(probs, [(u0, v0, 0.0, 0.0) for u0, v0 in windows])
    return [num / den if den > 0 else 0.0 for num, den, _, _ in sums]


def _gc_bits(probs, windows) -> list:
    """Pr(u <= g0 + r0 | u >= g0) at each (g0, r0) of ``windows``, in blocks."""
    sums = _sums(probs, [(0.0, 0.0, g0, r0) for g0, r0 in windows])
    return [num / den if den > 0 else 0.0 for _, _, den, num in sums]


def pr_user_bit(u0: float, v0: float, n: int = PAPER_N, alpha: float = 1.0,
                probs=None, device="cuda") -> float:
    """Pr(u <= u0 | v <= v0): a user write that invalidates a block of
    lifespan <= v0 itself has lifespan <= u0 (Fig 8). u0 and v0 in blocks;
    ``probs`` (a pmf array or tensor) replaces the Zipf(n, alpha) pmf. 0.0
    when no block has lifespan <= v0."""
    return _user_bits(_pmf(probs, n, alpha, device), [(u0, v0)])[0]


def pr_gc_bit(g0: float, r0: float, n: int = PAPER_N, alpha: float = 1.0,
              probs=None, device="cuda") -> float:
    """Pr(u <= g0 + r0 | u >= g0): a GC-rewritten block of age g0 has
    residual lifespan <= r0 (Fig 10). g0 and r0 in blocks. 0.0 when no block
    reaches age g0."""
    return _gc_bits(_pmf(probs, n, alpha, device), [(g0, r0)])[0]


def fig8a_grid(n: int = PAPER_N, alpha: float = 1.0, u0_gib=FIG8_WINDOWS_GIB,
               v0_gib=FIG8_WINDOWS_GIB, device="cuda") -> dict:
    """Fig 8(a): Pr(u<=u0 | v<=v0) over a (u0, v0) grid in GiB at fixed
    alpha, keyed by (u0, v0)."""
    keys = [(u0, v0) for u0 in u0_gib for v0 in v0_gib]
    values = _user_bits(zipf_pmf(n, alpha, device),
                        [(u0 * BLOCKS_PER_GIB, v0 * BLOCKS_PER_GIB) for u0, v0 in keys])
    return dict(zip(keys, values))


def fig8b_curve(n: int = PAPER_N, u0_gib: float = FIG8B_U0_GIB, v0_gib=FIG8_WINDOWS_GIB,
                alphas=FIG_ALPHAS, device="cuda") -> dict:
    """Fig 8(b): Pr(u<=u0 | v<=v0) against alpha at fixed u0, keyed by
    (alpha, v0)."""
    out = {}
    for a in alphas:
        values = _user_bits(zipf_pmf(n, a, device),
                            [(u0_gib * BLOCKS_PER_GIB, v0 * BLOCKS_PER_GIB) for v0 in v0_gib])
        out.update(((a, v0), value) for v0, value in zip(v0_gib, values))
    return out


def fig10a_grid(n: int = PAPER_N, alpha: float = 1.0, g0_gib=FIG10_G0_GIB,
                r0_gib=FIG10A_R0_GIB, device="cuda") -> dict:
    """Fig 10(a): Pr(u<=g0+r0 | u>=g0) over a (g0, r0) grid in GiB at fixed
    alpha, keyed by (g0, r0)."""
    keys = [(g0, r0) for g0 in g0_gib for r0 in r0_gib]
    values = _gc_bits(zipf_pmf(n, alpha, device),
                      [(g0 * BLOCKS_PER_GIB, r0 * BLOCKS_PER_GIB) for g0, r0 in keys])
    return dict(zip(keys, values))


def fig10b_curve(n: int = PAPER_N, r0_gib: float = FIG10B_R0_GIB, g0_gib=FIG10_G0_GIB,
                 alphas=FIG_ALPHAS, device="cuda") -> dict:
    """Fig 10(b): Pr(u<=g0+r0 | u>=g0) against alpha at fixed r0, keyed by
    (alpha, g0)."""
    out = {}
    for a in alphas:
        values = _gc_bits(zipf_pmf(n, a, device),
                          [(g0 * BLOCKS_PER_GIB, r0_gib * BLOCKS_PER_GIB) for g0 in g0_gib])
        out.update(((a, g0), value) for g0, value in zip(g0_gib, values))
    return out


def _lifespans(trace, device) -> tuple[torch.Tensor, torch.Tensor]:
    """For each write i of ``trace``: the index of the previous write of its
    LBA (-1 for the first), and the lifespan of the version it writes, i.e.
    the next write of its LBA minus i (-1 if never invalidated). int64, on
    ``device``."""
    tr = torch.as_tensor(np.asarray(trace)).to(resolve_device(device)).long()
    order = torch.argsort(tr, stable=True)          # by LBA, in trace order within one
    earlier, later = order[:-1], order[1:]
    same = tr[earlier] == tr[later]
    prev = torch.full_like(tr, -1)
    prev[later] = torch.where(same, earlier, -1)
    life = torch.full_like(tr, -1)
    life[earlier] = torch.where(same, later - earlier, -1)
    return prev, life


def _fraction(hit: torch.Tensor, sel: torch.Tensor) -> float:
    """Share of the selected writes that hit, as float64 integer counts
    divide; nan when nothing is selected."""
    hits, total = torch.stack([(hit & sel).sum(), sel.sum()]).tolist()
    return hits / total if total else float("nan")


def trace_conditional_user(trace, u0: int, v0: int, device="cuda") -> float:
    """Empirical Pr(u<=u0 | v<=v0) from a trace (paper Fig 9): over update
    requests whose invalidated predecessor lived <= v0, the fraction whose
    own lifespan is <= u0 (a version never invalidated counts as longer)."""
    prev, life = _lifespans(trace, device)
    v = life[prev.clamp(min=0)]                     # >= 1 wherever prev >= 0
    return _fraction((life >= 0) & (life <= u0), (prev >= 0) & (v <= v0))


def trace_conditional_gc(trace, g0: int, r0: int, device="cuda") -> float:
    """Empirical Pr(u<=g0+r0 | u>=g0) from a trace (paper Fig 11); a version
    never invalidated lives to the end of the trace."""
    _, life = _lifespans(trace, device)
    idx = torch.arange(life.numel(), device=life.device)
    u = torch.where(life >= 0, life, life.numel() - idx)
    return _fraction(u <= g0 + r0, u >= g0)
