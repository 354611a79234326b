"""Whether a run's jobs returned the right answers.

Every job's per-volume summaries are held, on every volume, to the
configuration's guarantees (each user write counted, per class too; no
allocation overflowing the pool) and to the log's accounting (the blocks
left in the log after GC, user plus GC writes less the reclaimed
segments', lie between the volume's live blocks and what the GC threshold
leaves); every job to the first (the replay is deterministic); and, on a
sample of volumes drawn from the seed, each to the plain reference
(`reference`), field for field. Each number compared is printed beside its
limit; every limit is 0, as every comparison is exact.
"""

from __future__ import annotations

import os

import numpy as np

from . import reference

FIELDS = ("user_writes", "gc_writes", "reclaimed", "overflow", "class_user_writes",
          "class_gc_writes", "ell")
LIMITS = {"jobs_failed": 0, "volumes_missing": 0, "writes_miscounted": 0, "pool_overflows": 0,
          "accounting_broken": 0, "jobs_disagreeing": 0, "reference_mismatches": 0}
# the replay kernel runs a few volumes to a thread block, one warp each:
# the sample takes every position in a block alike
LANES = 4


def arrays(volumes: list) -> dict:
    """A job's per-volume summaries as arrays, one per field."""
    return {f: np.asarray([v[f] for v in volumes]) for f in FIELDS}


def sample(job, seed: int, k: int) -> list:
    """``k`` volumes of the job's fleet drawn from ``seed``: spread over its
    tiles (each tile a policy), and within a tile over the positions in a
    thread block (index mod ``LANES``), the corpus' longest trace among
    them where the traces' lengths differ."""
    rng = np.random.default_rng(seed)
    V = job.corpus.shape[0]
    per = min(max(k // job.n_tiles, 1), V)
    picks = []
    for t in range(job.n_tiles):
        left = np.arange(V)
        for _ in range(per):
            lane = left[(t * V + left) % LANES == len(picks) % LANES]
            i = int(rng.choice(lane if lane.size else left))
            picks.append(t * V + i)
            left = left[left != i]
    writes = job.writes[:V]
    longest = int(np.argmax(writes))
    if writes.min() < writes.max() and all(p % V != longest for p in picks):
        tile = int(rng.integers(job.n_tiles))
        same = [n for n, p in enumerate(picks)
                if p // V == tile and p % LANES == (tile * V + longest) % LANES]
        picks[same[0] if same else tile * per] = tile * V + longest
    return sorted(picks)


def reference_volume(config: dict, trace, scheme: str, gp: float, n_segments: int,
                     precision: str = "float32") -> dict:
    """The reference's summary of one volume under the configuration."""
    return reference.replay(trace, n_lbas=config["n_lbas"], segment_size=config["segment_size"],
                            gp_threshold=gp, n_segments=n_segments, scheme=scheme,
                            nc_window=config["nc_window"],
                            max_gc_per_step=config["max_gc_per_step"],
                            class_slots=config["class_slots"],
                            sfs_resample=config["sfs_resample"], precision=precision)


def reference_outputs(job, picks: list, precision: str = "float32", workers: int = 0) -> dict:
    """The reference's summary of each picked volume, one process a volume
    (up to ``workers``, or the CPUs; 1: in this process)."""
    workers = min(len(picks), workers or os.cpu_count() or 1)
    if workers <= 1:
        return {k: reference_volume(job.config, *job.volume(k), job.n_segments, precision)
                for k in picks}
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = {k: pool.submit(reference_volume, job.config, *job.volume(k), job.n_segments,
                               precision) for k in picks}
        return {k: r.result() for k, r in runs.items()}


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[f], b[f]) for f in FIELDS)


def occupancy_limits(config: dict, gp: np.ndarray) -> tuple:
    """The least and the most blocks a volume's log may hold once a replay
    ends: its live blocks (the corpus writes every LBA, `traffic`), and
    what GC leaves at the threshold ``gp``, or, where no sealed segment
    holds garbage, the live blocks and the open segments."""
    n, s, c = config["n_lbas"], config["segment_size"], config["class_slots"]
    most = np.maximum(np.floor(n / (1.0 - gp.astype(np.float64))), n + c * s)
    return n, most


def judge(job, outs: list, failed: int, ref: dict, rows=None) -> dict:
    """The numbers compared, each ``[value, limit]``: jobs that raised;
    jobs short of volumes; volumes whose user writes, or per-class user or
    GC writes, do not add up to the trace's writes and the GC writes;
    volumes that overflowed the pool; volumes whose log holds fewer blocks
    than are live, or more than the GC threshold leaves, or that moved more
    blocks than their reclaimed segments held; jobs that differ anywhere
    from the first; sampled (job, volume) pairs that differ from the
    reference. ``outs`` are whole jobs: row r answers for the job's volume
    ``rows[r]`` (all of them in order where ``rows`` is None)."""
    rows = np.arange(job.n_volumes) if rows is None else np.asarray(rows)
    writes, gp = job.writes[rows], job.gp_of(rows)
    low, high = occupancy_limits(job.config, gp)
    s = job.config["segment_size"]
    whole = [o for o in outs if len(o["user_writes"]) == len(rows)]
    miscounted = overflows = broken = 0
    for o in whole:
        cu, cg = o["class_user_writes"].sum(axis=1), o["class_gc_writes"].sum(axis=1)
        miscounted += int(((o["user_writes"] != writes) | (cu != o["user_writes"])
                           | (cg != o["gc_writes"])).sum())
        overflows += int((o["overflow"] != 0).sum())
        moved = o["reclaimed"].astype(np.int64) * s
        occ = o["user_writes"].astype(np.int64) + o["gc_writes"] - moved
        broken += int(((occ < low) | (occ > high) | (o["gc_writes"] > moved)
                       | (o["reclaimed"] < 0)).sum())
    disagree = sum(not _same(o, whole[0]) for o in whole[1:])
    at = {int(k): r for r, k in enumerate(rows)}
    mismatches = 0
    for o in whole:
        for k, want in ref.items():
            mismatches += any(not np.array_equal(o[f][at[k]], np.asarray(want[f]))
                              for f in FIELDS)
    values = {"jobs_failed": failed + (not outs), "volumes_missing": len(outs) - len(whole),
              "writes_miscounted": miscounted, "pool_overflows": overflows,
              "accounting_broken": broken, "jobs_disagreeing": disagree,
              "reference_mismatches": mismatches}
    return {name: [values[name], LIMITS[name]] for name in LIMITS}


def correct(checks: dict) -> bool:
    return all(value <= limit for value, limit in checks.values())

