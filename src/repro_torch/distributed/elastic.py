"""Elastic scaling + straggler mitigation (control plane; numpy, the port keeps
its own copy of the JAX package's ``distributed/elastic.py``).

On node loss the runtime cannot keep the old mesh: we recompute the largest
feasible (data, model) mesh from the surviving device set, produce a
resharding plan, and resume from the last checkpoint step. Data order is
preserved because the pipeline is (step, shard)-addressable (training/data.py)
— shard reassignment is a pure function of the new topology.

Straggler mitigation: an SPMD program advances in lockstep, so mitigation is
assignment-level — hosts report per-step heartbeat durations; hosts slower
than ``threshold×median`` for ``patience`` consecutive steps get their data
shards reassigned (and are dropped from the mesh at the next elastic event).
All logic is host-side and unit-testable without real failures.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    pods: int
    dropped_hosts: tuple

    @property
    def n_devices(self):
        return self.data * self.model * self.pods


def plan_mesh(n_devices: int, *, model_parallel: int = 16,
              devices_per_pod: int = 256) -> MeshPlan:
    """Largest feasible mesh after failures: keep TP fixed (model weights are
    laid out for it), shrink data parallelism to the largest multiple that
    fits, drop the remainder."""
    pods = max(n_devices // devices_per_pod, 1) if n_devices >= devices_per_pod else 1
    per_pod = min(n_devices // pods, devices_per_pod)
    data = max(per_pod // model_parallel, 1)
    used = pods * data * model_parallel
    return MeshPlan(data=data, model=model_parallel, pods=pods,
                    dropped_hosts=tuple(range(used, n_devices)))


def reshard_plan(old: MeshPlan, new: MeshPlan) -> dict:
    """Describe the parameter movement for an elastic transition. With TP
    fixed, params are FSDP-sharded over 'data': shrinking data from d0 to d1
    regroups shard ranges — each new rank gathers ceil(d0/d1) old ranges."""
    ratio = (old.data + new.data - 1) // new.data
    moves = {r: tuple(range(r * old.data // new.data,
                            min((r + 1) * old.data // new.data + 1, old.data)))
             for r in range(new.data)}
    return {"gather_factor": ratio, "src_ranges": moves,
            "tp_unchanged": old.model == new.model}


@dataclasses.dataclass
class StragglerConfig:
    threshold: float = 1.5      # × median step time
    patience: int = 3


class StragglerDetector:
    def __init__(self, n_hosts: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.n_hosts = n_hosts
        self.strikes = np.zeros(n_hosts, dtype=np.int64)
        self.flagged: set[int] = set()

    def observe(self, step_times: np.ndarray) -> list[int]:
        """Feed per-host step durations; returns hosts newly flagged."""
        med = float(np.median(step_times))
        slow = step_times > self.cfg.threshold * med
        self.strikes = np.where(slow, self.strikes + 1, 0)
        newly = [h for h in range(self.n_hosts)
                 if self.strikes[h] >= self.cfg.patience and h not in self.flagged]
        self.flagged.update(newly)
        return newly

    def reassign_shards(self, n_shards: int) -> dict[int, list[int]]:
        """Spread the flagged hosts' data shards over healthy hosts."""
        healthy = [h for h in range(self.n_hosts) if h not in self.flagged]
        if not healthy:
            raise RuntimeError("no healthy hosts")
        assign: dict[int, list[int]] = {h: [] for h in healthy}
        for shard in range(n_shards):
            owner = shard % self.n_hosts
            if owner in self.flagged:
                assign[healthy[shard % len(healthy)]].append(shard)
            else:
                assign.setdefault(owner, []).append(shard)
        return assign
