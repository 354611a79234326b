"""Heterogeneous-config fleet sweeps, split across CUDA devices.

The counterpart of the JAX package's ``core/fleetshard.py``. A cloud block
store runs thousands of volumes with differing workloads and differing
tuning; a sweep replays scheme × selector × GP threshold (× GC schedule)
over one fleet:

1. **Policy encoding**: `FleetPolicy` holds the per-volume knobs (scheme,
   selector, GP threshold, nc window, GC schedule) as (V,) numpy arrays;
   `policy_grid` lays a (scheme × selector × gp) grid over a fleet,
   cell-major, so that ``tracegen.tiled_fleet`` replays the same workloads
   under every cell.
2. **Capacity sizing**: `hetero_config` pads the class axis to the widest
   scheme present and sizes the segment pool from the sweep's largest GP
   threshold (steady occupancy grows as live / (1 - gp)), so a
   mixed-threshold fleet never exhausts its pool spuriously.
3. **Device split**: `simulate_fleet_hetero` splits the volume axis into
   contiguous chunks, one per device, replays each chunk with one
   `torchsim.run_fleet` (all launched before any is read) and gathers the
   states in input order. Volumes are independent (the JAX package's
   provenance lints SA501-SA504 prove it), so no collective is needed.
4. **Scheme groups**: ``group=True`` (the default) replays each scheme's
   volumes under ``scheme_group=(name,)``, as JAX does to prune its
   dispatch; the results are bit-equal to the ungrouped replay. On the port
   the replay kernel dispatches per warp and the step engine per volume, so
   grouping prunes nothing here: it runs one replay per group.

A group's rows and a chunk's are selected with no host pass over the
traces: a slice, a view of the caller's rows, where the rows are one
ascending run (every scheme group of `policy_grid`'s cell-major layout,
every chunk); else one copy of the group, whose chunks are then slices of
it (`torchsim.trace_counts` counts the bytes copied).

The host's phases run inside `torchsim.span` ranges, which enclose no
device work: ``gather`` (a group's rows, then a chunk's), ``regroup`` (the
groups' states concatenated and put back in input order) and
``sweep_summary``; `torchsim` adds ``check_lbas``, ``next_writes`` and
``summaries``.

``engine`` is `torchsim.run_fleet`'s: ``"replay"`` (the replay kernel on the
card, one launch per group and device chunk whatever its schemes) or
``"step"``. Nothing is rerouted from one to the other.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .. import resolve_device
from ..convert import state_to_numpy
from . import torchsim
from .config import (
    GCSCHED_IDS,
    GCSCHED_NAMES,
    SCHEME_CLASSES,
    SCHEME_IDS,
    SCHEME_NAMES,
    SELECTOR_IDS,
    SELECTOR_NAMES,
    TorchSimConfig,
)


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Per-volume placement policy arrays, all shaped (V,)."""
    scheme_id: np.ndarray      # int32, config.SCHEME_IDS
    selector_id: np.ndarray    # int32, config.SELECTOR_IDS
    gp_threshold: np.ndarray   # float32
    nc_window: np.ndarray      # int32
    gcsched_id: np.ndarray | None = None    # int32, config.GCSCHED_IDS (None: all greedy)

    def __post_init__(self):
        if self.gcsched_id is None:
            object.__setattr__(self, "gcsched_id", np.zeros_like(self.scheme_id))
        v = len(self.scheme_id)
        for f in dataclasses.fields(self):
            if len(getattr(self, f.name)) != v:
                raise ValueError("policy arrays must share one fleet length")

    @property
    def n_volumes(self) -> int:
        return len(self.scheme_id)

    @property
    def n_classes(self) -> np.ndarray:
        """Per-volume live class count (from the scheme)."""
        return np.asarray(SCHEME_CLASSES, np.int32)[self.scheme_id]

    @property
    def max_classes(self) -> int:
        return int(self.n_classes.max())

    def as_state_arrays(self) -> dict:
        """The (V,) policy arrays of the port's state (``policies=`` of
        `torchsim.run_fleet`), ``p_classes`` included."""
        return {
            "p_scheme": np.asarray(self.scheme_id, np.int32),
            "p_selector": np.asarray(self.selector_id, np.int32),
            "p_gp": np.asarray(self.gp_threshold, np.float32),
            "p_ncw": np.asarray(self.nc_window, np.int32),
            "p_classes": np.asarray(self.n_classes, np.int32),
            "p_gcsched": np.asarray(self.gcsched_id, np.int32),
        }

    def volume(self, i: int) -> dict:
        """Scalar policy dict for volume ``i`` (`torchsim.run`'s ``policy=``)."""
        return {k: v[i] for k, v in self.as_state_arrays().items()}

    def describe(self, i: int) -> tuple[str, str, float]:
        return (SCHEME_NAMES[int(self.scheme_id[i])],
                SELECTOR_NAMES[int(self.selector_id[i])],
                float(self.gp_threshold[i]))

    def gcsched(self, i: int) -> str:
        return GCSCHED_NAMES[int(self.gcsched_id[i])]


def _coerce(values, v, ids=None, dtype=np.int32):
    """Broadcast a scalar / name / sequence to a (V,) policy array."""
    if isinstance(values, (str, int, float)):
        values = [values] * v
    if ids is not None:
        values = [ids[x] if isinstance(x, str) else x for x in values]
    out = np.asarray(values, dtype)
    if out.shape != (v,):
        raise ValueError(f"expected {v} per-volume values, got {out.shape}")
    return out


def encode_policies(n_volumes: int, *, schemes="sepbit", selectors="cost_benefit",
                    gp_thresholds=0.15, nc_windows=16, gcscheds="greedy") -> FleetPolicy:
    """Build a FleetPolicy from names/scalars (broadcast) or sequences."""
    return FleetPolicy(
        scheme_id=_coerce(schemes, n_volumes, SCHEME_IDS),
        selector_id=_coerce(selectors, n_volumes, SELECTOR_IDS),
        gp_threshold=_coerce(gp_thresholds, n_volumes, dtype=np.float32),
        nc_window=_coerce(nc_windows, n_volumes),
        gcsched_id=_coerce(gcscheds, n_volumes, GCSCHED_IDS),
    )


def policy_grid(schemes, selectors, gp_thresholds, *, volumes_per_cell: int = 1,
                nc_window: int = 16, gcsched: str = "greedy") -> tuple[FleetPolicy, list[tuple]]:
    """Cartesian (scheme × selector × gp) grid, ``volumes_per_cell`` volumes
    per cell, cell-major (cell 0's volumes first). Returns the policy and
    the cell list ``[(scheme, selector, gp), ...]`` in order. ``gcsched``
    applies fleet-wide."""
    cells = list(itertools.product(schemes, selectors, gp_thresholds))
    v = len(cells) * volumes_per_cell
    sch, sel, gp = zip(*(c for c in cells for _ in range(volumes_per_cell)))
    return encode_policies(v, schemes=list(sch), selectors=list(sel),
                           gp_thresholds=list(gp), nc_windows=nc_window,
                           gcscheds=gcsched), cells


def hetero_config(cfg: TorchSimConfig, policy: FleetPolicy) -> TorchSimConfig:
    """The config every volume of a heterogeneous fleet shares: the class
    axis padded to the widest scheme present, and (unless ``cfg`` fixes
    ``n_segments``) the segment pool sized from the largest GP threshold,
    the float32 value read back as a Python float, as JAX sizes it."""
    slots = max(policy.max_classes, cfg.class_slots or 0)
    base = dataclasses.replace(cfg, class_slots=slots)
    if cfg.n_segments is None:
        sized = dataclasses.replace(base, gp_threshold=float(np.max(policy.gp_threshold)))
        base = dataclasses.replace(base, n_segments=sized.s_max)
    return base


def matching_single_config(cfg: TorchSimConfig, policy: FleetPolicy, i: int) -> TorchSimConfig:
    """The single-volume config that volume ``i`` of a heterogeneous fleet
    equals bit for bit: its own knobs, with the pool size pinned to the
    fleet's (padded class slots are exact no-ops, so they need not agree)."""
    scheme, selector, gp = policy.describe(i)
    fleet_cfg = hetero_config(cfg, policy)
    return dataclasses.replace(
        cfg, scheme=scheme, selector=selector, gp_threshold=gp,
        nc_window=int(policy.nc_window[i]), n_segments=fleet_cfg.s_max,
        gc_sched=policy.gcsched(i), class_slots=None)


def scheme_groups(policy: FleetPolicy) -> list[tuple[str, np.ndarray]]:
    """The schemes present in a fleet and their volume indices, in id order."""
    return [(SCHEME_NAMES[int(sid)], np.nonzero(policy.scheme_id == sid)[0])
            for sid in np.unique(policy.scheme_id)]


def _devices(devices, device, shard: bool) -> list[torch.device]:
    """The devices a fleet is split across: ``devices`` when given, else
    every visible CUDA device for ``device="cuda"`` (one with ``shard``
    False), else ``[device]``."""
    if devices is None:
        dev = resolve_device(device)
        count = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
        devices = ([torch.device("cuda", i) for i in range(count)] if count > 1 else [dev])
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("no device to replay on")
    return devices if shard else devices[:1]


def _rows(padded: np.ndarray, idx: np.ndarray) -> tuple:
    """Rows ``idx`` of ``padded`` and the index that took them: a view and a
    slice where ``idx`` is one ascending run of consecutive rows, else a
    copy, whose bytes `torchsim.trace_counts` counts, and ``idx``."""
    if len(idx) and (np.diff(idx) == 1).all():
        rows = slice(int(idx[0]), int(idx[-1]) + 1)
        return padded[rows], rows
    out = padded[idx]
    torchsim.trace_counts["trace_copy_bytes"] += out.nbytes
    return out, idx


def _chunk(padded: np.ndarray, pol: dict, idx: np.ndarray) -> tuple[np.ndarray, dict]:
    """Rows ``idx`` of a padded fleet and of its policy arrays: views where
    ``idx`` is a contiguous range, as `np.array_split`'s chunks are."""
    with torchsim.span("gather"):
        traces, rows = _rows(padded, idx)
        return traces, {k: v[rows] for k, v in pol.items()}


def _replay_fleet(padded: np.ndarray, policy: FleetPolicy, cfg_h: TorchSimConfig,
                  devices: list, engine: str) -> dict:
    """One fleet replay (no grouping): the volume axis in contiguous chunks,
    one `torchsim.run_fleet` per device, every chunk launched before any is
    read; the final states (numpy) gathered in input order."""
    pol = policy.as_state_arrays()
    chunks = [idx for idx in np.array_split(np.arange(padded.shape[0]), len(devices)) if len(idx)]
    running = [torchsim.run_fleet(cfg_h, *_chunk(padded, pol, idx), device=dev, engine=engine)
               for idx, dev in zip(chunks, devices)]
    states = [state_to_numpy(st) for st in running]
    if len(states) == 1:
        return states[0]
    return {k: np.concatenate([s[k] for s in states]) for k in states[0]}


def _policy_rows(policy: FleetPolicy, idx) -> FleetPolicy:
    return FleetPolicy(scheme_id=policy.scheme_id[idx],
                       selector_id=policy.selector_id[idx],
                       gp_threshold=policy.gp_threshold[idx],
                       nc_window=policy.nc_window[idx],
                       gcsched_id=policy.gcsched_id[idx])


def _group(padded: np.ndarray, policy: FleetPolicy, idx: np.ndarray) -> tuple:
    """Rows ``idx`` of a padded fleet and of its policy: views where ``idx``
    is a contiguous range, else one copy."""
    with torchsim.span("gather"):
        traces, rows = _rows(padded, idx)
        return traces, _policy_rows(policy, rows)


def simulate_fleet_hetero(traces, cfg: TorchSimConfig, policy: FleetPolicy, *,
                          devices=None, shard: bool = True, group: bool = True,
                          return_state: bool = False, engine: str = "replay",
                          device="cuda"):
    """Replay a heterogeneous-config fleet, split across ``devices`` (None:
    every visible CUDA device, or ``[device]``; ``shard=False``: the first
    only) and, by default, grouped by placement scheme.

    ``traces``: list of 1-D LBA traces or a padded (V, T) matrix;
    ``policy``: per-volume knobs (`encode_policies` / `policy_grid`).
    ``cfg`` gives the shared shape knobs; its scheme, selector and GP are
    replaced by ``policy``'s. Every group shares the whole fleet's shapes
    (`hetero_config` over the whole policy), so per-volume results equal
    the ungrouped replay's and single-volume runs' bit for bit. Returns
    `torchsim.simulate_fleet`'s result dict, and with ``return_state`` the
    final batched state (numpy, volumes in input order) too."""
    padded = torchsim.coerce_fleet(traces)
    V = padded.shape[0]
    if policy.n_volumes != V:
        raise ValueError(f"policy covers {policy.n_volumes} volumes, traces cover {V}")
    if cfg.gc_engine == "legacy" and np.any(policy.gcsched_id != 0):
        raise ValueError("GC scheduling policies require the tick engine; "
                         "the legacy engine is the greedy parity oracle")
    cfg_h = hetero_config(cfg, policy)
    devs = _devices(devices, device, shard)

    groups = scheme_groups(policy) if group else [(None, np.arange(V))]
    states = []
    for name, idx in groups:
        cfg_g = cfg_h if name is None else dataclasses.replace(cfg_h, scheme_group=(name,))
        states.append(_replay_fleet(*_group(padded, policy, idx), cfg_g, devs, engine))
    if len(states) == 1:
        st = states[0]
    else:   # volumes back in input order
        with torchsim.span("regroup"):
            order = np.argsort(np.concatenate([idx for _, idx in groups]))
            st = {k: np.concatenate([s[k] for s in states])[order] for k in states[0]}

    res = torchsim.summarize_fleet(cfg_h, st, V)
    res["fleet"]["n_devices"] = len(devs)
    res["fleet"]["n_scheme_groups"] = len(groups)
    if return_state:
        return res, st
    return res


# -- sweep aggregation ---------------------------------------------------------

# two-sided 95 % Student-t critical values by degrees of freedom (df = n - 1);
# a sweep runs a handful of volumes per cell, where the normal 1.96 would
# understate the interval about 6.5x at n = 2
_T95 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 12: 2.179, 15: 2.131,
        20: 2.086, 30: 2.042}


def _t95(df: int) -> float:
    """Nearest tabulated value at or below ``df``: conservative (a wider
    interval) between table entries and past df = 30."""
    if df <= 0:
        return float("inf")
    return _T95[max(k for k in _T95 if k <= df)]


def sweep_summary(res: dict, policy: FleetPolicy, cells: list[tuple] | None = None) -> list[dict]:
    """One row per policy cell (scheme, selector, gp) of a heterogeneous
    fleet result: user and GC writes, the cell's WA, its per-volume median,
    mean and Student-t 95 % interval; in grid order when ``cells`` is given
    (else in order of first appearance). Timing runs add p50 / p99 from the
    cell's merged histogram, max, mean and the GC debt left."""
    groups: dict[tuple, dict] = {}
    order = []
    for i, vol in enumerate(res["volumes"]):
        key = policy.describe(i)
        if key not in groups:
            groups[key] = {"scheme": key[0], "selector": key[1], "gp_threshold": key[2],
                           "n_volumes": 0, "user_writes": 0, "gc_writes": 0,
                           "overflow": 0, "free_exhausted": 0, "per_volume_wa": []}
            order.append(key)
        g = groups[key]
        g["n_volumes"] += 1
        g["user_writes"] += vol["user_writes"]
        g["gc_writes"] += vol["gc_writes"]
        g["overflow"] += vol["overflow"]
        g["free_exhausted"] += vol["overflow"]
        g["per_volume_wa"].append(vol["wa"])
        if "latency" in vol:
            lat = vol["latency"]
            acc = g.setdefault("_lat", {"hist": np.zeros(len(lat["hist"]), np.int64),
                                        "max": 0.0, "total": 0.0, "gc_debt": 0.0,
                                        "write_cost": lat["write_cost"]})
            acc["hist"] += np.asarray(lat["hist"])
            acc["max"] = max(acc["max"], lat["max"])
            acc["total"] += lat["total"]
            acc["gc_debt"] += lat["gc_debt"]
    if cells is not None:
        # the keys hold float32 thresholds; match the grid's floats as such
        norm = [(s, sel, float(np.float32(gp))) for s, sel, gp in cells]
        order = [key for key in norm if key in groups]
    rows = []
    for key in order:
        g = groups[key]
        g["wa"] = (g["user_writes"] + g["gc_writes"]) / max(g["user_writes"], 1)
        wa = np.asarray(g["per_volume_wa"], dtype=np.float64)
        g["median_wa"] = float(np.median(wa))
        g["wa_mean"] = float(wa.mean())
        g["wa_ci95"] = (float(_t95(len(wa) - 1) * wa.std(ddof=1) / np.sqrt(len(wa)))
                        if len(wa) > 1 else 0.0)
        g["degraded"] = g["overflow"] > 0
        acc = g.pop("_lat", None)
        if acc is not None:
            g["lat_p50"] = torchsim.hist_quantile(acc["hist"], 0.50, acc["write_cost"])
            g["lat_p99"] = torchsim.hist_quantile(acc["hist"], 0.99, acc["write_cost"])
            g["lat_max"] = acc["max"]
            g["lat_mean"] = acc["total"] / max(g["user_writes"], 1)
            g["gc_debt"] = acc["gc_debt"]
        rows.append(g)
    return rows


def simulate_fleet_sweep(traces, cfg: TorchSimConfig, *, schemes, selectors, gp_thresholds,
                         nc_window: int = 16, gcsched: str = "greedy", devices=None,
                         shard: bool = True, group: bool = True, engine: str = "replay",
                         device="cuda") -> dict:
    """One-call sweep: ``traces`` holds ``cells × per_cell`` volumes laid out
    cell-major (``tracegen.tiled_fleet``). Returns the fleet result with the
    per-cell rows under ``"sweep"`` and the policy under ``"policy"``."""
    padded = torchsim.coerce_fleet(traces)
    cells = list(itertools.product(schemes, selectors, gp_thresholds))
    if padded.shape[0] % len(cells):
        raise ValueError(f"{padded.shape[0]} volumes do not tile a {len(cells)}-cell grid")
    per_cell = padded.shape[0] // len(cells)
    policy, cells = policy_grid(schemes, selectors, gp_thresholds, volumes_per_cell=per_cell,
                                nc_window=nc_window, gcsched=gcsched)
    res = simulate_fleet_hetero(padded, cfg, policy, devices=devices, shard=shard, group=group,
                                engine=engine, device=device)
    with torchsim.span("sweep_summary"):
        res["sweep"] = sweep_summary(res, policy, cells)
    res["policy"] = policy
    return res


def latency_cells(volumes: list[dict], cells: list[tuple], per_cell: int,
                  write_cost: float) -> tuple[list[dict], dict | None]:
    """The rows of the JAX package's latency bench (``benchmarks/run.py``
    ``latbench``, whose output is ``BENCH_gc_latency.json``) from a timing
    run's per-volume summaries, laid out cell-major over ``cells``
    ``[(gcsched, scheme), ...]`` with ``per_cell`` volumes each; and its
    ``slo`` row: the non-greedy cell with the largest p99 reduction against
    greedy in the same scheme, among those within +5 % of greedy's WA."""
    rows = []
    for ci, (g, s) in enumerate(cells):
        vols = volumes[ci * per_cell:(ci + 1) * per_cell]
        hist = np.sum([v["latency"]["hist"] for v in vols], axis=0)
        user = sum(v["user_writes"] for v in vols)
        gc = sum(v["gc_writes"] for v in vols)
        overflow = sum(v["overflow"] for v in vols)
        rows.append({
            "gcsched": g, "scheme": s, "n_volumes": per_cell,
            "user_writes": user, "gc_writes": gc, "wa": (user + gc) / max(user, 1),
            "overflow": overflow, "degraded": overflow > 0, "write_cost": write_cost,
            "p50": torchsim.hist_quantile(hist, 0.50, write_cost),
            "p99": torchsim.hist_quantile(hist, 0.99, write_cost),
            "max": max(v["latency"]["max"] for v in vols),
            "mean": sum(v["latency"]["total"] for v in vols) / max(user, 1),
            "gc_debt": sum(v["latency"]["gc_debt"] for v in vols),
        })
    by_cell = {(r["gcsched"], r["scheme"]): r for r in rows}
    slo = None
    for r in rows:
        base = by_cell.get(("greedy", r["scheme"]))
        if r["gcsched"] == "greedy" or base is None or base["p99"] <= 0:
            continue
        wa_ratio = r["wa"] / max(base["wa"], 1e-9)
        if wa_ratio > 1.05:
            continue
        cand = {"gcsched": r["gcsched"], "scheme": r["scheme"], "p99": r["p99"],
                "p99_greedy": base["p99"], "p99_reduction": 1.0 - r["p99"] / base["p99"],
                "wa": r["wa"], "wa_greedy": base["wa"], "wa_ratio": wa_ratio}
        if slo is None or cand["p99_reduction"] > slo["p99_reduction"]:
            slo = cand
    return rows, slo
