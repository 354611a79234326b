"""Synthetic block-trace generators (numpy; the port keeps its own copy).

The Alibaba Cloud traces are not redistributable, so workloads are synthetic
volumes calibrated to the paper's published statistics: Zipf-skewed updates,
the working set written once before the updates, and per-volume traffic of
several times the working set.

Each generator draws from ``numpy.random.default_rng(seed)`` in a fixed call
order, so one seed gives one trace; tests hold these arrays equal to the JAX
package's generators. The Alibaba CSV loader is not part of the port yet.
"""

from __future__ import annotations

import numpy as np


def zipf_probs(n: int, alpha: float) -> np.ndarray:
    """Zipf pmf p_i ∝ 1/i^alpha over ranks 1..n (paper §3.2)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def sample_from_probs(probs: np.ndarray, m: int, rng: np.random.Generator) -> np.ndarray:
    """Inverse-CDF sampling of m draws from an arbitrary pmf."""
    cdf = np.cumsum(probs)
    cdf[-1] = 1.0
    u = rng.random(m)
    return np.searchsorted(cdf, u, side="right").astype(np.int64)


def locality_permutation(n_lbas: int, locality: int, rng: np.random.Generator) -> np.ndarray:
    """Permute the LBA space in runs of ``locality`` consecutive addresses, so
    hotness has spatial locality."""
    if locality <= 1:
        return rng.permutation(n_lbas)
    n_runs = (n_lbas + locality - 1) // locality
    run_order = rng.permutation(n_runs)
    idx = (run_order[:, None] * locality + np.arange(locality)[None, :]).ravel()
    return idx[idx < n_lbas].astype(np.int64)


def zipf_trace(n_lbas: int, n_updates: int, alpha: float = 1.0, seed: int = 0,
               fill: bool = True, shuffle_ranks: bool = True,
               locality: int = 32) -> np.ndarray:
    """Optional sequential fill of the working set, then ``n_updates``
    Zipf(alpha) updates; rank→LBA is shuffled in ``locality``-sized runs."""
    rng = np.random.default_rng(seed)
    probs = zipf_probs(n_lbas, alpha)
    ranks = sample_from_probs(probs, n_updates, rng)
    if shuffle_ranks:
        perm = locality_permutation(n_lbas, locality, rng)
        updates = perm[ranks]
    else:
        updates = ranks
    if fill:
        fill_seq = np.arange(n_lbas, dtype=np.int64)
        return np.concatenate([fill_seq, updates])
    return updates


def hotcold_trace(n_lbas: int, n_updates: int, hot_frac: float = 0.2,
                  hot_prob: float = 0.8, seed: int = 0, fill: bool = True) -> np.ndarray:
    """``hot_frac`` of LBAs receive ``hot_prob`` of the update traffic,
    uniform within each set."""
    rng = np.random.default_rng(seed)
    n_hot = max(int(n_lbas * hot_frac), 1)
    is_hot = rng.random(n_updates) < hot_prob
    lbas = np.where(
        is_hot,
        rng.integers(0, n_hot, n_updates),
        rng.integers(n_hot, n_lbas, n_updates),
    ).astype(np.int64)
    perm = rng.permutation(n_lbas)
    lbas = perm[lbas]
    if fill:
        return np.concatenate([np.arange(n_lbas, dtype=np.int64), lbas])
    return lbas


def shifting_trace(n_lbas: int, n_updates: int, alpha: float = 1.0,
                   phases: int = 4, seed: int = 0, fill: bool = True) -> np.ndarray:
    """The working set drifts across ``phases`` epochs: each phase re-rolls
    the rank→LBA permutation."""
    rng = np.random.default_rng(seed)
    probs = zipf_probs(n_lbas, alpha)
    per = n_updates // phases
    parts = []
    for _ in range(phases):
        perm = rng.permutation(n_lbas)
        ranks = sample_from_probs(probs, per, rng)
        parts.append(perm[ranks])
    updates = np.concatenate(parts)
    if fill:
        return np.concatenate([np.arange(n_lbas, dtype=np.int64), updates])
    return updates


def sequential_trace(n_lbas: int, n_passes: int = 4) -> np.ndarray:
    """Sequential overwrite passes: the zero-skew extreme."""
    return np.tile(np.arange(n_lbas, dtype=np.int64), n_passes)


def add_bursts(updates: np.ndarray, rng: np.random.Generator, *,
               echo_prob: float = 0.5, gap_mean: float = 48.0,
               max_echoes: int = 3) -> np.ndarray:
    """Overlay bursty rewrites (paper Obs 2): each update spawns, with
    probability ``echo_prob``, 1..max_echoes short-gap re-updates of the same
    LBA, replacing later slots so the total traffic is unchanged."""
    m = len(updates)
    out = updates.copy()
    src = np.flatnonzero(rng.random(m) < echo_prob)
    for e in range(1, max_echoes + 1):
        keep = rng.random(len(src)) < (0.6 ** (e - 1))
        s = src[keep]
        gaps = rng.exponential(gap_mean * e, len(s)).astype(np.int64) + 1
        dst = s + gaps
        ok = dst < m
        out[dst[ok]] = updates[s[ok]]
    return out


def bursty_trace(n_lbas: int, n_updates: int, alpha: float = 1.0, seed: int = 0,
                 echo_prob: float = 0.5, gap_mean: float = 48.0,
                 locality: int = 32, fill: bool = True) -> np.ndarray:
    """Zipf base traffic plus burst echoes (Obs 2 workload)."""
    rng = np.random.default_rng(seed)
    base = zipf_trace(n_lbas, n_updates, alpha=alpha, seed=seed + 1,
                      locality=locality, fill=False)
    updates = add_bursts(base, rng, echo_prob=echo_prob, gap_mean=gap_mean)
    if fill:
        return np.concatenate([np.arange(n_lbas, dtype=np.int64), updates])
    return updates


def mixed_trace(n_lbas: int, n_updates: int, *, frac_static: float = 0.4,
                frac_rotate: float = 0.35, rotate_share: float = 0.3,
                alpha: float = 1.0, seed: int = 0, locality: int = 32,
                burst_echo_prob: float = 0.0, fill: bool = True) -> np.ndarray:
    """A static region written once, a rotating region rewritten circularly
    (``rotate_share`` of the updates), and a Zipf-hot region (paper §2.3)."""
    rng = np.random.default_rng(seed)
    n_static = int(n_lbas * frac_static)
    n_rotate = int(n_lbas * frac_rotate)
    n_hot = n_lbas - n_static - n_rotate
    if n_hot <= 0:
        raise ValueError("frac_static + frac_rotate must be < 1")
    rotate_base = n_static
    hot_base = n_static + n_rotate

    is_rotate = rng.random(n_updates) < rotate_share
    n_rot = int(np.count_nonzero(is_rotate))
    rotation = rotate_base + (np.arange(n_rot) % max(n_rotate, 1))
    probs = zipf_probs(n_hot, alpha)
    perm = locality_permutation(n_hot, locality, rng)
    hot = hot_base + perm[sample_from_probs(probs, n_updates - n_rot, rng)]
    updates = np.empty(n_updates, dtype=np.int64)
    updates[is_rotate] = rotation
    updates[~is_rotate] = hot
    if burst_echo_prob > 0:
        updates = add_bursts(updates, rng, echo_prob=burst_echo_prob)
    if fill:
        return np.concatenate([np.arange(n_lbas, dtype=np.int64), updates])
    return updates


GENERATORS = {
    "zipf": zipf_trace,
    "hotcold": hotcold_trace,
    "shifting": shifting_trace,
    "mixed": mixed_trace,
    "bursty": bursty_trace,
}


def trace_stats(trace: np.ndarray) -> dict:
    """Requests, working-set size, traffic over the working set and the
    fraction of requests that update an LBA already written."""
    uniq = np.unique(trace)
    return {
        "requests": int(len(trace)),
        "wss_lbas": int(len(uniq)),
        "traffic_over_wss": float(len(trace) / max(len(uniq), 1)),
        "update_fraction": float(1.0 - len(uniq) / max(len(trace), 1)),
    }
