"""Fleet trace generation for `torchsim.simulate_fleet` (numpy).

Each volume draws its own parameters (skew, phase count, burstiness) from a
scenario family, so a fleet replay exercises the ℓ estimator and victim
selection under heterogeneous traffic. Generators return a list of 1-D int64
traces (unequal lengths when ``jitter > 0``); `torchsim.pad_fleet` stacks
them. Same seeds, same traces as the JAX package's module.
"""

from __future__ import annotations

import numpy as np

from .traces import bursty_trace, shifting_trace, zipf_trace


def _lengths(n_updates: int, n_volumes: int, jitter: float,
             rng: np.random.Generator) -> np.ndarray:
    """Per-volume update counts: n_updates ± jitter fraction."""
    if jitter <= 0:
        return np.full(n_volumes, n_updates, dtype=np.int64)
    lo = max(int(n_updates * (1 - jitter)), 1)
    hi = int(n_updates * (1 + jitter)) + 1
    return rng.integers(lo, hi, n_volumes)


def zipf_mixture_fleet(n_volumes: int, n_lbas: int, n_updates: int, *,
                       alpha_range: tuple[float, float] = (0.6, 1.4),
                       jitter: float = 0.0, seed: int = 0) -> list[np.ndarray]:
    """Per-volume Zipf skew α ~ U[alpha_range]."""
    rng = np.random.default_rng(seed)
    alphas = rng.uniform(*alpha_range, n_volumes)
    lens = _lengths(n_updates, n_volumes, jitter, rng)
    return [zipf_trace(n_lbas, int(lens[i]), alpha=float(alphas[i]),
                       seed=seed + 1000 + i)
            for i in range(n_volumes)]


def shifting_hotspot_fleet(n_volumes: int, n_lbas: int, n_updates: int, *,
                           alpha: float = 1.0, phases: int = 6,
                           jitter: float = 0.0, seed: int = 0) -> list[np.ndarray]:
    """Per-volume phase count in 2..phases; the working set drifts."""
    rng = np.random.default_rng(seed)
    n_phases = rng.integers(2, max(phases, 2) + 1, n_volumes)
    lens = _lengths(n_updates, n_volumes, jitter, rng)
    return [shifting_trace(n_lbas, int(lens[i]), alpha=alpha,
                           phases=int(n_phases[i]), seed=seed + 2000 + i)
            for i in range(n_volumes)]


def msr_burst_fleet(n_volumes: int, n_lbas: int, n_updates: int, *,
                    alpha: float = 1.0, echo_range: tuple[float, float] = (0.3, 0.7),
                    gap_range: tuple[float, float] = (16.0, 96.0),
                    jitter: float = 0.0, seed: int = 0) -> list[np.ndarray]:
    """Zipf base traffic with echo rewrites at short exponential gaps."""
    rng = np.random.default_rng(seed)
    echo = rng.uniform(*echo_range, n_volumes)
    gaps = rng.uniform(*gap_range, n_volumes)
    lens = _lengths(n_updates, n_volumes, jitter, rng)
    return [bursty_trace(n_lbas, int(lens[i]), alpha=alpha,
                         echo_prob=float(echo[i]), gap_mean=float(gaps[i]),
                         seed=seed + 3000 + i)
            for i in range(n_volumes)]


FLEET_GENERATORS = {
    "zipf_mixture": zipf_mixture_fleet,
    "shifting_hotspot": shifting_hotspot_fleet,
    "msr_burst": msr_burst_fleet,
}


def mixed_fleet(n_volumes: int, n_lbas: int, n_updates: int, *,
                jitter: float = 0.0, seed: int = 0) -> list[np.ndarray]:
    """Round-robin over all scenario families — the default fleet workload."""
    fams = list(FLEET_GENERATORS.values())
    out: list[np.ndarray] = []
    for i in range(n_volumes):
        gen = fams[i % len(fams)]
        out.extend(gen(1, n_lbas, n_updates, jitter=jitter, seed=seed + 7919 * i))
    return out


def make_fleet(kind: str, n_volumes: int, n_lbas: int, n_updates: int,
               **kw) -> list[np.ndarray]:
    """Dispatch by family name (``mixed`` = round-robin over all)."""
    if kind == "mixed":
        return mixed_fleet(n_volumes, n_lbas, n_updates, **kw)
    if kind not in FLEET_GENERATORS:
        raise ValueError(f"unknown fleet kind {kind!r}; "
                         f"options: mixed, {', '.join(FLEET_GENERATORS)}")
    return FLEET_GENERATORS[kind](n_volumes, n_lbas, n_updates, **kw)


def tiled_fleet(kind: str, n_cells: int, per_cell: int, n_lbas: int,
                n_updates: int, **kw) -> list[np.ndarray]:
    """``per_cell`` scenario traces replicated across ``n_cells`` policy
    cells, cell-major (cell 0's copies first), so per-cell differences
    measure the policy, not trace luck."""
    base = make_fleet(kind, per_cell, n_lbas, n_updates, **kw)
    return [t for _ in range(n_cells) for t in base]
