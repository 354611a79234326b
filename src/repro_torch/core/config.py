"""Configuration, policy ids and the initial state of the replay engine.

`TorchSimConfig` has the fields and defaults of the JAX package's
``JaxSimConfig`` apart from ``use_kernels`` and ``kernels_interpret``: on the
port the device of the tensors decides whether a kernel or its plain
version runs. ``gc_engine="legacy"`` (the fused GC rewrite's oracle, greedy
GC schedule only) runs on the step engine (`torchsim.legacy_gc`).

``gc_batch_segments`` (k) is the numpy simulator's knob of the same name
(the paper's Exp#2): a GC operation checks the garbage proportion once and
then takes up to k victims, each the argmax of the rows sealed at its
start, with the whole rewrite of each; ``max_gc_per_step`` counts
operations. ``fifo_occupancy`` (the paper's Exp#5) adds
the state keys ``fifo_peak`` and ``fifo_last``: at every ℓ refresh of a
sepbit or uw volume, the LBAs whose last user write is within the last
``trunc(min(ℓ, t))`` writes are counted (numpy SepBIT's
``_sample_fifo_occupancy``), the largest count and the newest kept; -1
stands for no sample. Neither combines with the timing model, another GC
schedule than greedy or the legacy engine (nor does any reference path).
With the defaults (k = 1, no samples) the state and every transition are
JAX's.

``scheme_group`` names the schemes a fleet's volumes may run, as in JAX
(whose grouped dispatch prunes its branch stack to them); a volume outside
the group is refused. The port dispatches per volume anyway, so the group
changes no result.

The state is a dict of tensors with the JAX state's keys, the stateful
schemes' ``sch_<name>_*`` slices included (every volume carries all of
them), and a leading volume axis V (one volume is V = 1). Each key keeps
the JAX dtype and initial value.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .placement import stateful
from .placement.schemes import (  # noqa: F401  (SCHEME_NAMES: part of the id tables)
    SCHEME_CLASSES,
    SCHEME_IDS,
    SCHEME_NAMES,
    check_ids,
    scheme_id,
)

BIG = 2 ** 30
SELECTOR_IDS = {"greedy": 0, "cost_benefit": 1}
SELECTOR_NAMES = tuple(SELECTOR_IDS)
GCSCHED_IDS = {"greedy": 0, "rate_limited": 1, "idle_window": 2}
GCSCHED_NAMES = tuple(GCSCHED_IDS)
# latency histogram: quarter-octave log2 buckets of latency / write_cost;
# bucket b covers [2^(b/4), 2^((b+1)/4)) and quantiles report its lower edge
LAT_BUCKETS_PER_OCTAVE = 4

POLICY_DTYPES = {
    "p_scheme": torch.int32,
    "p_selector": torch.int32,
    "p_gp": torch.float32,
    "p_ncw": torch.int32,
    "p_classes": torch.int32,
    "p_gcsched": torch.int32,
}


@dataclasses.dataclass(frozen=True)
class TorchSimConfig:
    n_lbas: int
    segment_size: int = 128
    gp_threshold: float = 0.15
    selector: str = "cost_benefit"          # or "greedy"
    scheme: str = "sepbit"
    nc_window: int = 16
    max_gc_per_step: int = 64
    n_segments: int | None = None           # S_max; default sized from capacity
    class_slots: int | None = None          # pad the class axis (mixed fleets)
    sfs_resample: int = 4096
    gc_engine: str = "tick"
    scheme_group: tuple[str, ...] | None = None
    timing: bool = False
    write_cost: float = 1.0
    gc_block_cost: float = 1.0
    gc_sched: str = "greedy"
    gc_rate: int = 4
    gc_watermark: int | None = None
    idle_density: float = 0.5
    density_window: int = 16
    lat_buckets: int = 64
    gc_batch_segments: int = 1
    fifo_occupancy: bool = False

    def __post_init__(self):
        if self.selector not in SELECTOR_IDS:
            raise ValueError(f"unknown selector {self.selector!r}; choices: {SELECTOR_NAMES}")
        if self.gc_sched not in GCSCHED_IDS:
            raise ValueError(f"unknown gc_sched {self.gc_sched!r}; choices: {GCSCHED_NAMES}")
        if self.gc_engine not in ("tick", "legacy"):
            raise ValueError(f"unknown gc_engine {self.gc_engine!r}; choices: tick, legacy")
        scheme_id(self.scheme)
        for name in self.scheme_group or ():
            scheme_id(name)
        if self.gc_engine == "legacy" and self.gc_sched != "greedy":
            raise ValueError("GC scheduling policies require the tick engine; "
                             "the legacy engine is the greedy parity oracle")
        if self.gc_batch_segments < 1:
            raise ValueError(f"gc_batch_segments must be >= 1, got {self.gc_batch_segments}")
        if (self.gc_batch_segments > 1 or self.fifo_occupancy) and (
                self.gc_engine == "legacy" or self.timing or self.gc_sched != "greedy"):
            raise ValueError("gc_batch_segments > 1 and fifo_occupancy run on the tick engine "
                             "with the greedy GC schedule and the timing model off")

    @property
    def n_classes(self) -> int:
        return SCHEME_CLASSES[scheme_id(self.scheme)]

    @property
    def n_class_slots(self) -> int:
        """Width of the class axis; slots >= a volume's own class count are
        masked to no-ops."""
        return self.class_slots if self.class_slots is not None else self.n_classes

    @property
    def s_max(self) -> int:
        if self.n_segments is not None:
            return self.n_segments
        cap_segments = int(math.ceil(self.n_lbas / (1.0 - self.gp_threshold)
                                     / self.segment_size))
        return 2 * cap_segments + 4 * self.n_class_slots + 8

    @property
    def watermark_rows(self) -> int:
        if self.gc_watermark is not None:
            return self.gc_watermark
        return 2 * self.n_class_slots + 2

    @property
    def pad_row(self) -> int:
        """Index of the sacrificial overflow segment row (see init_state)."""
        return self.s_max

    @property
    def n_rows(self) -> int:
        return self.s_max + 1


def default_policy(cfg: TorchSimConfig) -> dict:
    """Per-volume policy values equivalent to the knobs in ``cfg``."""
    if cfg.scheme_group is not None and cfg.scheme not in cfg.scheme_group:
        raise ValueError(f"scheme {cfg.scheme!r} is outside this config's "
                         f"dispatch group {cfg.scheme_group}")
    return {
        "p_scheme": SCHEME_IDS[cfg.scheme],
        "p_selector": SELECTOR_IDS[cfg.selector],
        "p_gp": cfg.gp_threshold,
        "p_ncw": cfg.nc_window,
        "p_classes": cfg.n_classes,
        "p_gcsched": GCSCHED_IDS[cfg.gc_sched],
    }


def _policy_tensors(cfg: TorchSimConfig, policy: dict | None, device) -> dict:
    """``policy`` (scalars or (V,) arrays per key; None = ``cfg``'s knobs) as
    (V,) tensors of the state's dtypes, checked against what the port runs."""
    if policy is None:
        policy = default_policy(cfg)
    out = {}
    for key, dtype in POLICY_DTYPES.items():
        x = policy[key]
        x = torch.as_tensor(np.array(x) if isinstance(x, np.ndarray) else x)
        out[key] = x.to(device=device, dtype=dtype).reshape(-1)
    sizes = {x.numel() for x in out.values()}
    if len(sizes) != 1:
        raise ValueError(f"policy arrays differ in length: {sorted(sizes)}")
    ids = torch.unique(out["p_scheme"]).tolist()
    check_ids(ids)
    outside = [SCHEME_NAMES[i] for i in ids
               if cfg.scheme_group is not None and SCHEME_NAMES[i] not in cfg.scheme_group]
    if outside:
        raise ValueError(f"policy schemes {outside} are outside this config's "
                         f"dispatch group {cfg.scheme_group}")
    if not set(torch.unique(out["p_gcsched"]).tolist()) <= set(range(len(GCSCHED_NAMES))):
        raise ValueError(f"unknown GC scheduling policy id; choices: {GCSCHED_NAMES}")
    if ((cfg.gc_batch_segments > 1 or cfg.fifo_occupancy)
            and bool((out["p_gcsched"] != GCSCHED_IDS["greedy"]).any())):
        raise ValueError("gc_batch_segments > 1 and fifo_occupancy run under the greedy GC "
                         "schedule only")
    if bool((out["p_classes"] > cfg.n_class_slots).any()):
        raise ValueError(f"a policy uses more classes than cfg.n_class_slots "
                         f"= {cfg.n_class_slots}; set class_slots")
    return out


def state_spec(cfg: TorchSimConfig) -> dict:
    """Per-volume shape and dtype of every state key (no allocation)."""
    R, s, C, n = cfg.n_rows, cfg.segment_size, cfg.n_class_slots, cfg.n_lbas
    i32, f32 = torch.int32, torch.float32
    spec = {
        "seg_lba": ((R, s), i32), "seg_utime": ((R, s), i32), "seg_valid": ((R, s), torch.bool),
        "seg_n": ((R,), i32), "seg_nvalid": ((R,), i32), "seg_cls": ((R,), i32),
        "seg_state": ((R,), i32),     # 0 free, 1 open, 2 sealed, 3 reserved
        "seg_ctime": ((R,), i32), "seg_stime": ((R,), i32),
        "open_sid": ((C,), i32),
        "loc_seg": ((n,), i32), "loc_off": ((n,), i32), "last_uw": ((n,), i32),
    }
    for key in ("t", "total_occ", "total_valid", "user_writes", "gc_writes", "reclaimed",
                "overflow"):
        spec[key] = ((), i32)
    spec.update({"ell": ((), f32), "ell_tot": ((), f32), "nc": ((), i32),
                 "class_user": ((C,), i32), "class_gc": ((C,), i32)})
    # the latency model's keys exist with timing off too (one key set);
    # only lat_dens, the write-density EWMA, changes while timing is off
    for key in ("lat_now", "lat_busy", "lat_debt", "lat_charged", "lat_dens", "lat_sum",
                "lat_max"):
        spec[key] = ((), f32)
    spec["lat_hist"] = ((cfg.lat_buckets,), i32)
    spec.update({key: (shape, dtype) for key, (shape, dtype, _) in
                 stateful.state_spec(cfg).items()})
    if cfg.fifo_occupancy:
        spec.update({key: ((), i32) for key in FIFO_KEYS})
    spec.update({key: ((), dtype) for key, dtype in POLICY_DTYPES.items()})
    return spec


# SepBIT's FIFO-occupancy samples (cfg.fifo_occupancy): the largest and the
# newest; -1 before the first
FIFO_KEYS = ("fifo_peak", "fifo_last")
_FILL = {"loc_seg": -1, "last_uw": -BIG, "ell": math.inf, "fifo_peak": -1, "fifo_last": -1}


def init_state(cfg: TorchSimConfig, policy: dict | None = None, device="cuda") -> dict:
    """Initial state of V volumes, V being the length of the policy arrays.

    Segment arrays carry one extra sacrificial row (``cfg.pad_row``, state 3
    = reserved): when the free pool is exhausted, allocations land there
    instead of on a live row, and each such allocation is counted in
    ``overflow``. The first ``p_classes`` segments start open, one per live
    class; padded class slots leave their row in the free pool."""
    pol = _policy_tensors(cfg, policy, device)
    V = pol["p_scheme"].numel()
    fill = {**_FILL, **{key: f for key, (_, _, f) in stateful.state_spec(cfg).items()}}
    state = {}
    for key, (shape, dtype) in state_spec(cfg).items():
        if key in pol:
            state[key] = pol[key]
        elif isinstance(fill.get(key), tuple):     # a per-slot initial vector
            state[key] = torch.tensor(fill[key], dtype=dtype, device=device).repeat(V, 1)
        else:
            state[key] = torch.full((V,) + shape, fill.get(key, 0), dtype=dtype,
                                    device=device)
    C = cfg.n_class_slots
    slot = torch.arange(C, dtype=torch.int32, device=device)
    live = slot[None, :] < pol["p_classes"][:, None]
    state["open_sid"][:] = slot
    state["seg_state"][:, :C] = live.to(torch.int32)
    state["seg_cls"][:, :C] = torch.where(live, slot, 0)
    state["seg_state"][:, cfg.pad_row] = 3
    return state
