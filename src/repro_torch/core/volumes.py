"""The synthetic volume pool of the paper-table benchmarks (numpy; the port
keeps its own copy).

Ten named volumes: stationary Zipf, hot/cold mixes, drifting working sets,
bursty rewrites and the mixed static / rotating / Zipf-hot layout of the
paper's §2.3 observations. Every volume writes its working set once, then
8x its size in updates. Seeds and generator calls are the JAX package's, so
each trace is array-equal to its counterpart there.
"""

from __future__ import annotations

import numpy as np

from .traces import bursty_trace, hotcold_trace, mixed_trace, shifting_trace, zipf_trace


def default_pool(scale: int = 1) -> list[tuple[str, np.ndarray]]:
    """Named volume pool. ``scale`` multiplies the working set (1: 16Ki-LBA
    volumes, fast enough for tests; 4: benchmark-grade, 64Ki LBAs and
    589,824 writes per volume)."""
    n = (1 << 14) * scale
    vols: list[tuple[str, np.ndarray]] = []
    for i, (fs, fr, rs, alpha, echo) in enumerate((
            (0.40, 0.35, 0.30, 1.0, 0.4),
            (0.30, 0.40, 0.40, 1.1, 0.0),
            (0.50, 0.25, 0.25, 0.9, 0.5),
            (0.20, 0.50, 0.50, 1.2, 0.3),
    )):
        vols.append((f"mixed{i}", mixed_trace(
            n, 8 * n, frac_static=fs, frac_rotate=fr, rotate_share=rs,
            alpha=alpha, seed=40 + i, burst_echo_prob=echo)))
    vols.append(("bursty_a0.9", bursty_trace(n, 8 * n, alpha=0.9, seed=51)))
    vols.append(("bursty_a1.1", bursty_trace(n, 8 * n, alpha=1.1, seed=52,
                                             echo_prob=0.6)))
    vols.append(("zipf1.0", zipf_trace(n, 8 * n, alpha=1.0, seed=12)))
    vols.append(("hotcold_10_90", hotcold_trace(n, 8 * n, 0.1, 0.9, seed=21)))
    vols.append(("shift4_a1.0", shifting_trace(n, 8 * n, alpha=1.0, phases=4, seed=31)))
    vols.append(("shift8_a1.2", shifting_trace(n, 8 * n, alpha=1.2, phases=8, seed=32)))
    return vols


def overall_wa(results) -> float:
    """Traffic-weighted write amplification across volumes: (user + GC
    writes) / user writes, from objects with ``user_writes`` and
    ``gc_writes``; 1.0 when nothing was written."""
    user = sum(r.user_writes for r in results)
    gc = sum(r.gc_writes for r in results)
    return (user + gc) / user if user else 1.0
