"""The per-volume replay kernel: a whole fleet replay in one launch.

A state on the card goes to the hand-written kernel in ``csrc/replay.cu``
(one warp per volume runs every user write of its trace and its GC loop,
with victim selection and GC classification inside; a block holds up to
four volumes, and where a volume's rows fit, its segment metadata lives in
shared memory for the whole replay: `geometry`). The kernel's plain
version is the step engine of `core.torchsim` (`_user_write` and
`fleet_gc_tick` once per lockstep step), which `torchsim` runs for a state
on the CPU; this wrapper takes only CUDA tensors and raises on any other.
There is no fallback from one to the other. With ``cfg.timing`` the kernel
runs the timing model (its ``lat_*`` keys), and for idle_window volumes the
GC schedule's deferral, as the step engine does; and where some volume runs
one of the nine stateful schemes (fk, dac, ml, sfs, eti, mq, sfr, fadac,
warcip), their classes and ``sch_*`` tables (``csrc/stateful_ops.cuh``).
Each is an instance of the kernel of its own, so the instance with all
three off runs none of it. All 14 schemes run in one launch, mixed in one
fleet as they may be; fk reads its (V, T) next-write stream ``nxt``. The
legacy GC engine is refused (`ValueError`), never handed to the step
engine, which runs it under ``engine="step"``. ``cfg.gc_batch_segments``
(GC operations of k victims) and ``cfg.fifo_occupancy`` (SepBIT's
FIFO-occupancy samples into ``fifo_peak`` / ``fifo_last``) are runtime
fields of the launch; with either one the kernel's kPaper instances run
(greedy GC, timing off), so the others carry none of that code.
``launches`` counts the kernel's launches: ``replay`` with the timing model
off, ``replay_timing`` with it on.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import FIFO_KEYS, GCSCHED_IDS, TorchSimConfig, state_spec
from ..core.placement import stateful
from ..core.placement.schemes import SCHEME_IDS, SCHEMES, check_ids
from . import build

launches = {"replay": 0, "replay_timing": 0}   # the timing model's instances apart

# the state keys the kernel reads or writes, in the order of ReplayArgs in
# csrc/replay.cu. The timing model's keys (TIMING_FIELDS) it touches only
# with cfg.timing, p_gcsched only then or when some volume runs
# idle_window, and the stateful schemes' tables (SCHEME_FIELDS, in
# stateful.state_spec's order) only where some volume runs their scheme
TIMING_FIELDS = ("lat_now", "lat_busy", "lat_debt", "lat_charged", "lat_sum", "lat_max",
                 "lat_hist")
SCHEME_FIELDS = tuple(stateful.state_spec(TorchSimConfig(n_lbas=1)))
STATE_FIELDS = ("seg_lba", "seg_utime", "seg_valid", "seg_n", "seg_nvalid", "seg_cls",
                "seg_state", "seg_ctime", "seg_stime", "open_sid", "loc_seg", "loc_off",
                "last_uw", "t", "total_occ", "total_valid", "user_writes", "gc_writes",
                "reclaimed", "overflow", "ell", "ell_tot", "nc", "class_user", "class_gc",
                "lat_dens", *TIMING_FIELDS, *SCHEME_FIELDS, "p_scheme", "p_selector", "p_gp",
                "p_ncw", "p_classes", "p_gcsched")
IDLE_WINDOW = GCSCHED_IDS["idle_window"]
FK, SFS = SCHEME_IDS["fk"], SCHEME_IDS["sfs"]


class ReplayArgs(ctypes.Structure):
    _fields_ = ([(key, ctypes.c_void_p) for key in STATE_FIELDS]
                + [(name, ctypes.c_void_p) for name in ("trace", "iterations", "nxt",
                                                        "sfs_keys", *FIFO_KEYS,
                                                        "fifo_window")]
                + [(name, ctypes.c_int) for name in ("n_volumes", "n_steps", "n_rows",
                                                     "seg_size", "n_classes", "n_lbas",
                                                     "max_gc")]
                + [("dens_keep", ctypes.c_float), ("dens_add", ctypes.c_float),
                   ("timing", ctypes.c_int), ("defer", ctypes.c_int)]
                + [(name, ctypes.c_float) for name in ("write_cost", "gc_block_cost",
                                                       "charge_cap", "idle_density", "ln2")]
                + [(name, ctypes.c_int) for name in ("watermark_rows", "lat_buckets",
                                                     "stateful", "sfs_resample", "warps",
                                                     "shared_meta", "smem_per_warp",
                                                     "gc_batch", "fifo")])


class Instance(NamedTuple):
    """What `check_inputs` learned of a fleet, for `launch` (which makes no
    host sync): whether some volume runs idle_window (the kDefer instance),
    some volume a stateful scheme (kStateful), some volume fk (the kernel
    reads ``nxt``), how many volumes run sfs (its refresh's scratch has a
    row for each) and whether the segment metadata fits the narrow fields
    it takes in shared memory (``narrow``: every row but the pad row with
    fill and valid counts in [0, segment_size], every state and class in
    [0, 255], as any state `init_state` or a replay made has them)."""

    defer: bool
    stateful: bool
    fk: bool
    n_sfs: int
    narrow: bool


# The kernel's geometry, as csrc/replay.cu lays it out (kMaxWarps, Vars,
# warp_layout; the launch refuses a geometry whose bytes differ from its own)
MAX_WARPS = 4                  # volumes (warps) per block
MAX_BLOCK_SMEM = 232_448       # shared memory a block may use on Hopper (227 KB)
VARS_BYTES = 96                # a stateful scheme's and the timing model's per-volume scalars
SCAN_CHUNK = 256               # kStateful: a compacted victim scan's rows (one byte a row)
H100_SMS = 132


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def warp_bytes(cfg: TorchSimConfig, stateful: bool, shared_meta: bool) -> int:
    """Shared memory of one warp: a stateful scheme's and the timing model's
    scalars, the free rows (C ints), the victim's slots (LBAs, times, valid
    flags; in the stateful instance, classes too and its compacted victim
    scan's rows) and, with ``shared_meta``, the segment metadata: 10 bytes a
    row (fill and valid counts as the 16-bit halves of one word, seal time,
    state and class bytes) and the pad row's two 32-bit counts."""
    s, R, C = cfg.segment_size, cfg.n_rows, cfg.n_class_slots
    total = VARS_BYTES + _align16(4 * C) + 2 * _align16(4 * s) + _align16(s)
    if stateful:
        total += _align16(4 * s) + SCAN_CHUNK
    if shared_meta:
        total += 2 * _align16(4 * R) + 2 * _align16(R) + 16
    return total


class Geometry(NamedTuple):
    """A launch's shape: ``warps`` volumes a block, ``blocks`` blocks,
    whether the segment metadata lives in shared memory (the kSharedMeta
    instance) and the shared memory of a warp and of a block."""

    warps: int
    blocks: int
    shared_meta: bool
    warp_bytes: int
    block_bytes: int


def geometry(cfg: TorchSimConfig, V: int, stateful: bool = False, narrow: bool = True,
             n_sms: int = H100_SMS) -> Geometry:
    """The launch of ``V`` volumes: up to MAX_WARPS volumes a block, fewer
    where the fleet is smaller than the card (one volume an SM up to
    ``n_sms`` volumes, so no SM holds two while another idles); the
    metadata in shared memory when a block of MAX_WARPS volumes fits
    MAX_BLOCK_SMEM with it and ``narrow`` (`Instance`) holds. The pad row's
    counts are 32-bit there, so the shared layout takes every class-slot
    count and segment size the kernel does; only the rows' number decides."""
    warps = min(MAX_WARPS, max(1, -(-V // n_sms)))
    shared_meta = bool(narrow) and MAX_WARPS * warp_bytes(cfg, stateful, True) <= MAX_BLOCK_SMEM
    per_warp = warp_bytes(cfg, stateful, shared_meta)
    return Geometry(warps, -(-V // warps), shared_meta, per_warp, warps * per_warp)


_SIGNATURES = {"replay_launch": [ctypes.POINTER(ReplayArgs), ctypes.c_void_p],
               "replay_limits": [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)],
               "replay_occupancy": [ctypes.POINTER(ReplayArgs), ctypes.POINTER(ctypes.c_int)]}


def check_inputs(cfg: TorchSimConfig, st: dict, trace, nxt=None) -> Instance:
    """Raise unless ``cfg`` runs the tick engine (the legacy engine is
    refused first: it runs under ``engine="step"``), every volume runs the
    greedy GC schedule where ``cfg`` asks for GC operations of k > 1
    victims or the FIFO samples, every state key is a contiguous tensor of
    its dtype and shape for ``cfg`` with one leading volume axis, ``trace``
    a contiguous (V, T) int32 tensor of LBAs in
    [-1, n_lbas) (-1: a pad step) on the same device, every volume's scheme
    in the table, ``nxt`` (fk's next-write stream; needed when some volume
    runs fk) a contiguous (V, T) int32 tensor on that device, that device
    CUDA, and the segment size and class slots within the kernel's limits.
    Returns the `Instance` the fleet needs, read here with the other checks
    so that the launch itself makes no host sync."""
    if cfg.gc_engine == "legacy":
        raise ValueError("gc_engine='legacy' is the fused GC rewrite's oracle and runs on the "
                         "step engine: pass engine=\"step\" (the replay kernel implements the "
                         "tick engine's fused rewrite)")
    if not isinstance(trace, torch.Tensor) or trace.dtype != torch.int32 or trace.dim() != 2:
        raise TypeError("trace must be a (V, T) int32 tensor")
    V = trace.shape[0]
    device = trace.device
    if not trace.is_contiguous():
        raise ValueError("trace must be contiguous")
    for key, (shape, dtype) in state_spec(cfg).items():
        x = st.get(key)
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"state[{key!r}] must be a tensor")
        if x.dtype != dtype:
            raise TypeError(f"state[{key!r}] must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != (V,) + shape:
            raise ValueError(f"state[{key!r}] has shape {tuple(x.shape)}, expected "
                             f"{(V,) + shape} for {V} volumes")
        if not x.is_contiguous():
            raise ValueError(f"state[{key!r}] must be contiguous")
        if x.device != device:
            raise ValueError(f"state[{key!r}] is on {x.device}, the trace on {device}")
    if ((cfg.gc_batch_segments > 1 or cfg.fifo_occupancy)
            and bool((st["p_gcsched"] != GCSCHED_IDS["greedy"]).any())):
        raise ValueError("gc_batch_segments > 1 and fifo_occupancy run under the greedy GC "
                         "schedule only")
    if trace.numel():   # one reduction, no (V, T) temporary
        lo, hi = torch.aminmax(trace)
        if bool((lo < -1) | (hi >= cfg.n_lbas)):
            raise ValueError(f"trace LBAs must lie in [0, {cfg.n_lbas}) or be -1 (a pad step)")
    ids = torch.unique(st["p_scheme"]).tolist()
    check_ids(ids)
    fk = FK in ids
    if nxt is not None:
        if not isinstance(nxt, torch.Tensor) or nxt.dtype != torch.int32:
            raise TypeError("nxt (fk's next-write stream) must be an int32 tensor")
        if tuple(nxt.shape) != tuple(trace.shape):
            raise ValueError(f"nxt has shape {tuple(nxt.shape)}, the trace {tuple(trace.shape)}")
        if not nxt.is_contiguous():
            raise ValueError("nxt must be contiguous")
        if nxt.device != device:
            raise ValueError(f"nxt is on {nxt.device}, the trace on {device}")
    elif fk:
        raise ValueError("a volume runs fk, which reads the next-write stream: pass nxt "
                         "(annotate.fleet_annotations)")
    if device.type != "cuda":
        raise ValueError(f"the replay kernel takes CUDA tensors, not {device}; the step "
                         f"engine (torchsim.step_replay) is its plain version on the CPU")
    max_seg, max_cls = ctypes.c_int(), ctypes.c_int()
    build.library("replay", _SIGNATURES).replay_limits(ctypes.byref(max_seg),
                                                       ctypes.byref(max_cls))
    if cfg.segment_size > max_seg.value or cfg.n_class_slots > max_cls.value:
        raise ValueError(f"the replay kernel takes segment_size <= {max_seg.value} and at most "
                         f"{max_cls.value} class slots")
    return Instance(defer=bool((st["p_gcsched"] == IDLE_WINDOW).any()),
                    stateful=any(SCHEMES[i].elementwise is None for i in ids), fk=fk,
                    n_sfs=int((st["p_scheme"] == SFS).sum()) if SFS in ids else 0,
                    narrow=narrow_metadata(cfg, st))


def narrow_metadata(cfg: TorchSimConfig, st: dict) -> bool:
    """Whether the state's segment metadata fits the narrow fields the
    kernel keeps in shared memory: every row but the pad row with its fill
    and valid counts in [0, segment_size] (a replay keeps them there), every
    state and class in [0, 255]. The pad row's counts are 32-bit there."""
    counts = torch.cat([st["seg_n"][:, :-1], st["seg_nvalid"][:, :-1]], dim=1)
    codes = torch.cat([st["seg_state"], st["seg_cls"]], dim=1)
    wide = ((counts < 0) | (counts > cfg.segment_size)).any() | ((codes < 0) | (codes > 255)).any()
    return not bool(wide)


def _geometry_args(cfg: TorchSimConfig, V: int, inst: Instance, device) -> tuple:
    """The launch's `Geometry` on ``device``'s SM count, and a `ReplayArgs`
    with the fields that name the instance and the geometry set (the
    pointers null)."""
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    geo = geometry(cfg, V, inst.stateful, inst.narrow, n_sms)
    args = ReplayArgs(n_volumes=V, n_rows=cfg.n_rows, seg_size=cfg.segment_size,
                      n_classes=cfg.n_class_slots, timing=int(cfg.timing),
                      defer=int(inst.defer), stateful=int(inst.stateful), warps=geo.warps,
                      shared_meta=int(geo.shared_meta), smem_per_warp=geo.warp_bytes,
                      gc_batch=cfg.gc_batch_segments, fifo=int(cfg.fifo_occupancy))
    return geo, args


def occupancy(cfg: TorchSimConfig, V: int, inst: Instance, device="cuda") -> dict:
    """The instance a launch of ``V`` volumes would run, without launching
    it: its geometry, its registers and local memory a thread, its resident
    blocks per SM (CUDA's occupancy calculator), the volumes the card holds
    at once and the waves the fleet takes."""
    device = torch.device(device)
    geo, args = _geometry_args(cfg, V, inst, device)
    out = (ctypes.c_int * 3)()
    err = build.library("replay", _SIGNATURES).replay_occupancy(ctypes.byref(args), out)
    if err != 0:
        raise RuntimeError(f"replay kernel occupancy query failed with CUDA error {err}")
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    resident = out[0] * geo.warps * n_sms
    return {"warps": geo.warps, "blocks": geo.blocks, "shared_meta": geo.shared_meta,
            "block_bytes": geo.block_bytes, "registers": out[1], "local_bytes": out[2],
            "blocks_per_sm": out[0], "resident": resident,
            "waves": -(-V // resident) if resident else None}


def launch(cfg: TorchSimConfig, st: dict, trace, iterations, inst: Instance,
           nxt=None) -> None:
    """One launch of the kernel on inputs that passed `check_inputs`, with a
    zeroed (T,) int32 ``iterations`` buffer on the card that receives, per
    step, the most GC iterations any volume ran, ``inst`` as `check_inputs`
    returned it and fk's ``nxt`` (read only when some volume runs fk; a null
    pointer otherwise). No host sync."""
    V, T = trace.shape
    device = trace.device
    a = np.float32(1.0 / cfg.density_window)
    f32 = [float(np.float32(x)) for x in (cfg.write_cost, cfg.gc_block_cost,
                                          cfg.gc_rate * cfg.gc_block_cost, cfg.idle_density,
                                          math.log(2.0))]
    # sfs's refresh writes its keys here, a row per sfs volume; nothing reads
    # them after the launch
    keys = (torch.empty((inst.n_sfs, cfg.n_lbas), dtype=torch.int32, device=device)
            if inst.n_sfs else None)
    # the FIFO samples' scratch: a step's widest and newest window, -1 none
    window = (torch.full((V, 2), -1, dtype=torch.int32, device=device)
              if cfg.fifo_occupancy else None)
    geo, _ = _geometry_args(cfg, V, inst, device)
    fifo = [st[key].data_ptr() if cfg.fifo_occupancy else None for key in FIFO_KEYS]
    fifo.append(None if window is None else window.data_ptr())
    args = ReplayArgs(*(st[key].data_ptr() for key in STATE_FIELDS), trace.data_ptr(),
                      iterations.data_ptr(), nxt.data_ptr() if inst.fk else None,
                      None if keys is None else keys.data_ptr(), *fifo, V, T, cfg.n_rows,
                      cfg.segment_size, cfg.n_class_slots, cfg.n_lbas, cfg.max_gc_per_step,
                      float(np.float32(1.0) - a), float(a), int(cfg.timing), int(inst.defer),
                      *f32, cfg.watermark_rows, cfg.lat_buckets, int(inst.stateful),
                      cfg.sfs_resample, geo.warps, int(geo.shared_meta), geo.warp_bytes,
                      cfg.gc_batch_segments, int(cfg.fifo_occupancy))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = build.library("replay", _SIGNATURES).replay_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"replay kernel launch failed with CUDA error {err}")
    # the C side launches nothing for no volumes
    launches["replay_timing" if cfg.timing else "replay"] += 1 if V else 0


def replay(cfg: TorchSimConfig, st: dict, trace, stats=None, nxt=None) -> None:
    """Replay the (V, T) int32 ``trace`` through the state ``st`` (made by
    `torchsim.own_state`, on the card) in place: per step, each volume's
    user write and its GC loop; a -1 step of a volume is skipped whole.
    ``nxt``: fk's (V, T) int32 next-write stream, needed when some volume
    runs fk (`torchsim._next_writes` makes it). With ``stats`` (a
    `torchsim.ReplayStats`), adds the steps, the steps whose GC loop ran and
    the fleet's tick iterations (per step, the most any volume ran), as the
    step engine counts them; they come back with one read after the launch,
    the replay's only host sync."""
    inst = check_inputs(cfg, st, trace, nxt)
    iterations = torch.zeros(trace.shape[1], dtype=torch.int32, device=trace.device)
    launch(cfg, st, trace, iterations, inst, nxt)
    if stats is not None:
        per_step = iterations.cpu()
        stats.steps += trace.shape[1]
        stats.gc_ticks += int((per_step > 0).sum())
        stats.tick_iterations += int(per_step.sum())
        stats.host_syncs += 1
