"""Cells, configurations and the replay job a cell's caller submits.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; it names a
configuration (``configs/<config>.json``: the deployment) and a traffic mix
(``traffic/<traffic>.json``: the corpus' families and the job's entry and
policies). Nothing here is specific to one cell: a new cell is a new entry
and, where it needs them, new data files.

A job is one call of the port's entry on the corpus held in host memory,
returning a per-volume summary for every volume; the port is imported only
when a job is made.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np

from . import reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SIM_KEYS = ("n_lbas", "segment_size", "scheme", "selector", "gc_sched", "gp_threshold",
            "timing", "class_slots", "nc_window", "max_gc_per_step", "sfs_resample")
ENTRIES = ("simulate_fleet_sweep", "simulate_fleet")


def _load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, its configuration
    and traffic files' contents, and the metrics it reports (end-to-end and
    per-layer, each as ``BENCHMARK.json`` lists it)."""
    bench = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; choices: {', '.join(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return {"name": name, "chips": w["chips"], "config": _load("configs", w["config"]),
            "traffic": _load("traffic", w["traffic"]), "end_to_end": e2e, "per_layer": layer}


class Job:
    """The job of one cell: the corpus ``traces`` (a (V, T) int32 host
    array, -1 padded) laid out as the entry takes it, and the call. Volume k
    of a job's fleet replays corpus trace ``k % V`` under tile ``k // V``'s
    policy."""

    def __init__(self, config: dict, traffic: dict, traces: np.ndarray, device="cuda"):
        job = traffic["job"]
        if job["entry"] not in ENTRIES:
            raise ValueError(f"unknown entry {job['entry']!r}; choices: {ENTRIES}")
        self.config, self.job, self.device = config, job, device
        self.corpus = traces
        if job["entry"] == "simulate_fleet_sweep":
            self.n_tiles = (len(job["schemes"]) * len(job["selectors"])
                            * len(job["gp_thresholds"]))
            self.fleet = np.ascontiguousarray(np.tile(traces, (self.n_tiles, 1)))
            # cell-major, in the entry's (scheme, selector, gp) order
            self.tiles = [(scheme, gp) for scheme, _, gp in itertools.product(
                job["schemes"], job["selectors"], job["gp_thresholds"])]
        else:
            self.n_tiles = 1
            self.fleet = traces
            self.tiles = [(config["scheme"], config["gp_threshold"])]
        self.n_volumes = self.fleet.shape[0]
        self.writes = (self.fleet >= 0).sum(axis=1)   # user writes each volume must count
        self.total_writes = int(self.writes.sum())
        self.n_segments = reference.pool_rows(config["n_lbas"], config["segment_size"],
                                              max(gp for _, gp in self.tiles),
                                              config["class_slots"])

    def run(self) -> list:
        """One call of the entry; its per-volume summaries."""
        from repro_torch.core import fleetshard, torchsim
        from repro_torch.core.config import TorchSimConfig
        cfg, job = TorchSimConfig(**{k: self.config[k] for k in SIM_KEYS}), self.job
        if job["entry"] == "simulate_fleet_sweep":
            res = fleetshard.simulate_fleet_sweep(
                self.fleet, cfg, schemes=job["schemes"], selectors=job["selectors"],
                gp_thresholds=job["gp_thresholds"], group=job["group"], device=self.device)
        else:
            res = torchsim.simulate_fleet(self.fleet, cfg, device=self.device)
        return res["volumes"]

    def gp_of(self, ks) -> np.ndarray:
        """The GC threshold of each volume ``ks`` of the job's fleet."""
        gps = np.asarray([gp for _, gp in self.tiles], dtype=np.float64)
        return gps[np.asarray(ks) // self.corpus.shape[0]]

    def volume(self, k: int) -> tuple:
        """Volume ``k``'s corpus trace, scheme and GC threshold."""
        V = self.corpus.shape[0]
        return (self.corpus[k % V], *self.tiles[k // V])
