"""The replay engine: user writes, GP-triggered GC and SepBIT's ℓ estimate.

The counterpart of the JAX package's tick engine (``jaxsim``), written in
eager PyTorch over a leading volume axis V; one volume is V = 1. Every state
transition is the JAX engine's, in the same order, so final states match it
bit for bit:

- `_user_write` invalidates the predecessor, classifies the block (the
  classify kernel with is_gc = 0, then the stateful schemes' branches for
  their volumes), appends it to the class's open segment and seals a full
  segment;
- `fleet_gc_tick` runs GC ticks while any volume's garbage proportion
  exceeds its threshold: the victims come from the segsel kernel
  (`segment_select_batch`; `segment_select` for one volume), the classes of
  the victims' live blocks from the classify kernel and the stateful
  branches, and `_gc_once` moves them with one segmented scatter over
  (class, rank) keys. Volumes that do not trigger are left exactly as they
  were. With ``cfg.gc_batch_segments`` = k > 1 a tick is one GC operation
  of up to k victims, each selected and rewritten in turn;
- under ``cfg.gc_engine="legacy"``, `legacy_gc` instead: JAX's pre-tick
  loop, the fused rewrite's oracle. A victim is selected at loop entry on
  every user write, and `_gc_once_legacy` rewrites it class slot by class
  slot, one scatter per JAX ``.at[...]``. Both rewrites share their head
  (`_gc_bookkeeping`: ℓ, the classes, the fresh rows) and their tail
  (`_gc_release`). With ``cfg.fifo_occupancy`` the head also takes SepBIT's
  FIFO-occupancy sample at each ℓ refresh (`_sample_fifo`).

With ``cfg.timing`` the timing model of ``jaxsim`` runs beside it: each
user write's latency (`_user_write`) into the ``lat_*`` keys, each rewrite's
GC time booked as debt (`_gc_release`), and the debt charged to the device's
busy horizon after the step's GC (`_charge_gc`). The per-volume GC schedule
``p_gcsched`` decides when: greedy and idle_window charge it all at once,
rate_limited at most ``gc_rate`` blocks' worth per step; idle_window also
defers GC while the write density is high and the free pool above its
watermark (`_gc_deferred`), with timing on or off, as in JAX.

Every registered scheme runs here: the five elementwise schemes through the
classify kernel, the nine stateful ones (fk, dac, ml, sfs, eti, mq, sfr,
fadac, warcip) through `placement.stateful`, each on its own volumes and
its own ``sch_<name>_*`` keys. fk reads a (V, T) int32 ``nxt`` stream beside
the trace, the index of each write's next write to its LBA (`annotate`).

The engine updates its state in place on a private copy (`inplace`). The GC
loop asks the host whether any volume still needs GC before each tick
iteration: one host sync per iteration, plus the one per step that finds
none. `ReplayStats` counts steps, iterations and host syncs.

The host's phases around a replay each run inside a `span`, a profiler
range named ``repro_torch.fleet.<phase>`` that encloses no device work: the
host's wait for the LBA check's verdict (``check_lbas``; the check itself
runs where the trace lies, `_check_lbas`), fk's stream (``next_writes``) and
the summaries (``summaries``); `summarize_fleet` counts its calls and the
bytes of state its summaries read (`summary_counts`), and `trace_counts`
the trace rows the fleet API copied on the host.

That is the step engine (``engine="step"``). By default (``engine="replay"``)
`run` and `run_fleet` hand a state on the card to the replay kernel
(`kernels.replay`): one launch replays every volume under any of the 14
schemes, fk's ``nxt`` beside the trace, with no host sync per step; it takes
the tick engine only, and refuses the legacy engine rather than hand it to
the step engine. For a state on the CPU they run the kernel's plain version,
the step engine (`step_replay`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..convert import state_to_numpy
from ..kernels.classify import classify
from ..kernels.replay import replay as replay_kernel
from ..kernels.segsel import segment_select, segment_select_batch
from .annotate import coerce_fleet_annotations, fleet_annotations
from .config import (
    BIG,
    GCSCHED_IDS,
    GCSCHED_NAMES,
    LAT_BUCKETS_PER_OCTAVE,
    SCHEME_NAMES,
    SELECTOR_NAMES,
    TorchSimConfig,
    default_policy,
    init_state,
)
from .inplace import Consts, own_state
from .inplace import add as _add
from .inplace import put as _put
from .placement import stateful
from .placement.schemes import SCHEME_IDS, SCHEME_REQUIRES_FUTURE

ENGINES = ("replay", "step")

# process-wide counts of the fleet summaries: the calls of `summarize_fleet`
# and the bytes of state its `_summary` calls read. Read with the launch
# counts through `kernels.ops` (`host_counts`), zeroed by its
# `reset_launch_counts`
summary_counts = {"summary_bytes": 0, "fleet_summaries": 0}
# process-wide count of the bytes of trace rows the fleet API copied on the
# host (`fleetshard`'s row selections, `run_fleet`'s contiguous copy): 0
# where every selection was a view. Read and zeroed through `kernels.ops`
trace_counts = {"trace_copy_bytes": 0}


def span(phase: str):
    """A ``torch.profiler`` range named ``repro_torch.fleet.<phase>`` around
    one host phase of a replay. It encloses NumPy or Python work only: a
    range around device work would also show as a row on the device."""
    return record_function(f"repro_torch.fleet.{phase}")


@dataclasses.dataclass
class ReplayStats:
    """Counts of one replay, in an object the caller passes and owns (the
    process-wide counts live in `kernels.ops`' registry): lockstep steps,
    steps whose GC loop ran at least once, GC tick iterations (per step, the
    most any volume ran), and the host syncs the engine made while replaying
    (the step engine: one per tick iteration and one per step that finds no
    volume over its threshold; the replay kernel: one read of its counts
    after the launch). The checks before a replay (scheme ids, pad steps,
    LBA range) are not counted; the ``repro_torch.fleet.check_lbas`` span
    times the LBA check on the host (`run`) or the host's wait for its
    verdict (`run_fleet`) instead (`span`)."""

    steps: int = 0
    gc_ticks: int = 0
    tick_iterations: int = 0
    host_syncs: int = 0


def _gp(st):
    """Garbage proportion per volume."""
    occ = torch.clamp(st["total_occ"], min=1).to(torch.float32)
    return 1.0 - st["total_valid"].to(torch.float32) / occ


def _alloc_free_ids(cfg: TorchSimConfig, seg_state, ranks):
    """(V, count) int64 indices of each volume's first ``count`` free rows in
    ascending order (``ranks`` holds 1..count per volume). Past the end of
    the free pool the fill is ``cfg.pad_row``, the sacrificial row that is
    never free. A rank over a cumulative count keeps the shape static
    (``torch.nonzero`` would sync)."""
    cum = torch.cumsum(seg_state == 0, dim=1, dtype=torch.int32)
    # not found gives n_rows; a found row is below pad_row, which is never free
    return torch.searchsorted(cum, ranks).clamp_(max=cfg.pad_row)


def _user_write(cfg: TorchSimConfig, st: dict, lbas, active, k: Consts, nxt=None,
                sfs_refresh=None):
    """One user write per volume, in place. ``lbas`` is (V,) int64. With
    ``active`` (V,) bool, the masked write: volumes where it is False (the
    -1 pad steps of a shorter trace) are left as they were, ``sch_*`` keys
    included. ``nxt`` (V,) int32 is the write's next-write index, read by
    fk (None: none known); ``sfs_refresh`` says whether some sfs volume
    refreshes its bounds at this step (see `stateful.UserWrite`)."""
    s, pad = cfg.segment_size, cfg.pad_row
    t = st["t"]
    if active is None:
        act, one, lba = k.true, k.ones_v, lbas
    else:
        act, one, lba = active, active.to(torch.int32), torch.clamp(lbas, min=0)

    # invalidate the predecessor (none for a fresh LBA: loc_seg = -1); only
    # the over-capacity pad row holds offsets >= s, and JAX drops those
    loc = k.lba0 + lba
    old_sid = st["loc_seg"].view(-1)[loc]
    old_off = st["loc_off"].view(-1)[loc]
    had_old = (old_sid >= 0) & act
    had_old_i = had_old.to(torch.int32)
    old_row = k.row0 + old_sid * had_old_i
    _put(st["seg_valid"], k.kept(st["seg_valid"], old_row * s + old_off,
                                 had_old & (old_off < s)), k.false)
    _add(st["seg_nvalid"], old_row, -had_old_i)
    v = t - st["last_uw"].view(-1)[loc]   # huge for a fresh LBA: "infinite lifespan"

    # the block's class: the classify kernel with is_gc = 0
    cls = classify(v[:, None], k.zeros_v1, k.zeros_v1, k.zeros_v1, st["ell"],
                   st["p_scheme"], site="user")[:, 0]
    if k.stateful:
        # the stateful volumes' classes, from their schemes' tables
        cls = stateful.user_classes(cfg, st, stateful.UserWrite(lba, t, nxt, act, k,
                                                                sfs_refresh), cls)
    cls_flat = k.cls0 + cls
    sid = st["open_sid"].view(-1)[cls_flat]
    sid_row = k.row0 + sid
    off = st["seg_n"].view(-1)[sid_row]
    # off reaches s only on the over-capacity pad row: dropped
    new = k.kept(st["seg_lba"], sid_row * s + off, (off < s) & act)
    _put(st["seg_lba"], new, lba.to(torch.int32))
    _put(st["seg_utime"], new, t)
    _put(st["seg_valid"], new, k.true)
    _add(st["seg_n"], sid_row, one)
    _add(st["seg_nvalid"], sid_row, one)
    # the pad row's fill count never exceeds s (every write caps it), so
    # capping every volume's leaves the inactive ones as they were
    st["seg_n"][:, pad].clamp_(max=s)
    at = loc if active is None else k.kept(st["loc_seg"], loc, act)
    _put(st["loc_seg"], at, sid)
    _put(st["loc_off"], at, off)
    _put(st["last_uw"], at, t)

    # seal a full segment and promote a free one to open
    fresh = _alloc_free_ids(cfg, st["seg_state"], k.rank1)[:, 0]
    sealed = (st["seg_n"].view(-1)[sid_row] >= s) & act
    at = k.kept(st["seg_state"], sid_row, sealed)
    _put(st["seg_state"], at, k.i32[2])
    _put(st["seg_stime"], at, t)
    at = k.kept(st["seg_state"], k.row0 + fresh, sealed)
    _put(st["seg_state"], at, k.i32[1])
    _put(st["seg_cls"], at, cls)
    _put(st["seg_ctime"], at, t)
    _put(st["open_sid"], k.kept(st["open_sid"], cls_flat, sealed), fresh.to(torch.int32))

    # write-density EWMA (the idle_window scheduler's signal), a multiply
    # then an add, kept as two ops; the float32 constants go in as Python
    # floats (a device tensor made from a host value would cost a copy)
    a = np.float32(1.0 / cfg.density_window)
    dens = st["lat_dens"] * float(np.float32(1.0) - a) + float(a)
    st["lat_dens"] = dens if active is None else torch.where(active, dens, st["lat_dens"])
    if cfg.timing:
        _user_latency(cfg, st, active, one, k)
    st["t"] = t + one
    st["total_occ"] = st["total_occ"] + one
    st["total_valid"] = st["total_valid"] + (one - had_old_i)
    st["user_writes"] = st["user_writes"] + one
    st["overflow"] = st["overflow"] + (sealed & (fresh == pad)).to(torch.int32)
    _add(st["class_user"], cls_flat, one)


def _keep(new, old, active):
    return new if active is None else torch.where(active, new, old)


def _user_latency(cfg: TorchSimConfig, st: dict, active, one, k: Consts):
    """The timing model's part of a user write (closed loop): the write
    arrives when the previous one completed (``lat_now``), waits for any
    charged GC work still on the device (``lat_busy``), then takes
    ``write_cost``; its latency goes into the sums and the histogram. The
    bucket's log2 is ``log(x) / log(2)`` in float32, as JAX computes it."""
    wc = k.f32["write_cost"]
    arrive = st["lat_now"]
    latency = torch.clamp(st["lat_busy"] - arrive, min=0.0) + wc
    log2 = torch.log(latency / wc) / k.f32["ln2"]
    bucket = torch.clamp(torch.floor(LAT_BUCKETS_PER_OCTAVE * log2), 0, cfg.lat_buckets - 1)
    st["lat_now"] = _keep(arrive + latency, arrive, active)
    st["lat_sum"] = _keep(st["lat_sum"] + latency, st["lat_sum"], active)
    st["lat_max"] = _keep(torch.maximum(st["lat_max"], latency), st["lat_max"], active)
    _add(st["lat_hist"], k.base(cfg.lat_buckets) + bucket.to(torch.int64), one)


class GcHead(NamedTuple):
    """What both GC engines read of each volume's victim before they rewrite
    it: its index (clamped to 0 where there is none) and flat row, its live
    block count and fill, its slots' LBAs and write times, each slot's GC
    class (-1 for a dead slot) and the C candidate fresh rows (int64)."""

    victim: torch.Tensor
    vrow: torch.Tensor
    k_total: torch.Tensor
    victim_n: torch.Tensor
    lba_v: torch.Tensor
    utime_v: torch.Tensor
    classes: torch.Tensor
    free_ids: torch.Tensor


def _gc_bookkeeping(cfg: TorchSimConfig, st: dict, victims, do, k: Consts) -> GcHead:
    """The shared head of both GC engines (JAX's ``_gc_bookkeeping``), in
    place where ``do``: ℓ estimation (Algorithm 1 lines 4-9: Class-1 victims
    feed the running lifespan total; every ``p_ncw`` of them ℓ becomes their
    mean), then the live blocks' GC classes from the classify kernel with
    is_gc = 1, v = 0, g the block's age and from_c1 the victim's class (a
    stateful volume's from its scheme, which may update its tables under the
    refreshed ℓ), then the fresh-row candidates."""
    s = cfg.segment_size
    V = victims.shape[0]
    victim = torch.clamp(victims, min=0)             # do implies victims >= 0
    vrow = k.row0 + victim
    k_total = st["seg_nvalid"].view(-1)[vrow]
    victim_n = st["seg_n"].view(-1)[vrow]
    lba_v = st["seg_lba"].view(-1, s)[vrow]
    utime_v = st["seg_utime"].view(-1, s)[vrow]
    valid_v = st["seg_valid"].view(-1, s)[vrow]

    is_c1 = st["seg_cls"].view(-1)[vrow] == 0
    nc = st["nc"] + is_c1.to(torch.int32)
    life = (st["t"] - st["seg_ctime"].view(-1)[vrow]).to(torch.float32)
    ell_tot = st["ell_tot"] + torch.where(is_c1, life, k.zero_f)
    refresh = nc >= st["p_ncw"]
    ell = torch.where(refresh, ell_tot / torch.clamp(nc, min=1), st["ell"])
    nc = nc.masked_fill(refresh, 0)
    ell_tot = ell_tot.masked_fill(refresh, 0.0)
    st["ell"] = torch.where(do, ell, st["ell"])
    st["ell_tot"] = torch.where(do, ell_tot, st["ell_tot"])
    st["nc"] = torch.where(do, nc, st["nc"])
    if k.fifo is not None:
        _sample_fifo(st, do & refresh & k.fifo)

    g = st["t"][:, None] - utime_v
    from_c1 = is_c1.to(torch.int32)[:, None].expand(V, s).contiguous()
    gc_cls = classify(k.zeros_vs, g, from_c1, k.ones_vs, ell, st["p_scheme"])
    if k.stateful:
        gc_cls = stateful.gc_classes(cfg, st, stateful.GcVictims(
            lba_v.long(), valid_v, st["t"], do, k), gc_cls)
    classes = torch.where(valid_v, gc_cls, k.i32[-1])
    free_ids = _alloc_free_ids(cfg, st["seg_state"], k.rankC)
    return GcHead(victim, vrow, k_total, victim_n, lba_v, utime_v, classes, free_ids)


def _sample_fifo(st: dict, sample):
    """SepBIT's FIFO-occupancy sample (numpy ``_sample_fifo_occupancy``),
    in place where ``sample`` and ℓ is finite: the LBAs whose last user
    write is at or after ``t - trunc(min(ℓ, t))``, into ``fifo_last`` and
    the running maximum ``fifo_peak``."""
    t, ell = st["t"], st["ell"]
    w = torch.minimum(ell.double(), t.double()).to(torch.int32)
    count = (st["last_uw"] >= (t - w)[:, None]).sum(1, dtype=torch.int32)
    sample = sample & torch.isfinite(ell)
    st["fifo_last"] = torch.where(sample, count, st["fifo_last"])
    st["fifo_peak"] = torch.where(sample, torch.maximum(st["fifo_peak"], count), st["fifo_peak"])


def _gc_release(cfg: TorchSimConfig, st: dict, h: GcHead, do, k: Consts):
    """The shared tail of both GC engines, in place where ``do``: cap the
    pad row's fill count (over-capacity appends to it were dropped; it never
    exceeds s otherwise, so volumes without GC stay as they were), release
    the victim (the pad row, a victim only after exhaustion promoted it,
    returns to reserved state 3, never to the free pool), and count the
    rewrite: occupancy, GC writes, reclaimed segments and, with the timing
    model, its device time booked as debt (charged after the step)."""
    s, pad = cfg.segment_size, cfg.pad_row
    st["seg_n"][:, pad].clamp_(max=s)
    at = k.kept(st["seg_state"], h.vrow, do)
    _put(st["seg_state"], at, torch.where(h.victim == pad, k.i32[3], k.i32[0]))
    _put(st["seg_n"], at, k.i32[0])
    _put(st["seg_nvalid"], at, k.i32[0])
    _put(st["seg_valid"], k.kept(st["seg_valid"], h.vrow[:, None] * s + k.slots, do[:, None]),
         k.false)
    # total_valid is untouched: GC moves valid blocks, never creates them
    st["total_occ"] = torch.where(do, st["total_occ"] - h.victim_n + h.k_total, st["total_occ"])
    st["gc_writes"] = st["gc_writes"] + h.k_total * do
    st["reclaimed"] = st["reclaimed"] + do.to(torch.int32)
    if cfg.timing:
        debt = st["lat_debt"] + h.k_total.to(torch.float32) * k.f32["gc_block_cost"]
        st["lat_debt"] = torch.where(do, debt, st["lat_debt"])


def _gc_once(cfg: TorchSimConfig, st: dict, victims, do, k: Consts):
    """Rewrite each volume's victim segment where ``do`` (in place): the live
    blocks, classed by `_gc_bookkeeping`, move with one scatter per array to
    their class's open segment, spilling into a fresh free segment once it
    is full. Volumes where ``do`` is False are left as they were."""
    s, C, pad = cfg.segment_size, cfg.n_class_slots, cfg.pad_row
    V = victims.shape[0]
    doc = do[:, None]
    h = _gc_bookkeeping(cfg, st, victims, do, k)
    classes, free_ids, lba_v = h.classes, h.free_ids, h.lba_v

    # per-slot (class, rank) keys: rank = position among same-class live slots
    slot_cls = torch.clamp(classes, 0, C - 1).to(torch.int64)
    onehot = classes[:, :, None] == k.cls_ids
    cum = torch.cumsum(onehot, dim=1, dtype=torch.int32)            # (V, s, C)
    rank = torch.gather(cum, 2, slot_cls[:, :, None])[:, :, 0] - 1
    per_cls = cum[:, -1, :]                                         # (V, C)

    # per-class destinations: the open segment, then a fresh one. Padded
    # class slots (>= p_classes) count no blocks, and their stale open_sid
    # is masked out of every metadata write below
    cls_active = k.cls_ids[None, :] < st["p_classes"][:, None]
    sids = st["open_sid"].to(torch.int64)
    n0 = torch.gather(st["seg_n"], 1, sids)
    room = torch.clamp(s - n0, min=0)   # a pad-row open segment can sit at capacity
    took1 = torch.minimum(per_cls, room)
    took2 = per_cls - took1

    live = classes >= 0
    room_s = torch.gather(room, 1, slot_cls)
    in_first = live & (rank < room_s)
    dst_sid = torch.where(in_first, torch.gather(sids, 1, slot_cls),
                          torch.gather(free_ids, 1, slot_cls))
    dst_off = torch.where(in_first, torch.gather(n0, 1, slot_cls) + rank, rank - room_s)
    moved = live & doc
    at = k.kept(st["seg_lba"], (k.row0[:, None] + dst_sid) * s + dst_off,
                moved & (dst_off < s))
    _put(st["seg_lba"], at, lba_v)
    _put(st["seg_utime"], at, h.utime_v)
    _put(st["seg_valid"], at, k.true)
    at = k.kept(st["loc_seg"], k.lba0[:, None] + lba_v, moved)
    _put(st["loc_seg"], at, dst_sid.to(torch.int32))
    _put(st["loc_off"], at, dst_off)

    # per-class metadata, as masked (V, C) scatters: fill counts, first-block
    # time, seal-if-full and promote-fresh
    open_rows = k.row0[:, None] + sids
    fresh_rows = k.row0[:, None] + free_ids
    for key in ("seg_n", "seg_nvalid"):
        _add(st[key], open_rows, took1 * doc)
        _add(st[key], fresh_rows, took2 * doc)
    t_c = st["t"][:, None].expand(V, C)
    _put(st["seg_ctime"], k.kept(st["seg_ctime"], open_rows, doc & (n0 == 0) & (per_cls > 0)),
         t_c)
    sealed = cls_active & (n0 + took1 >= s)
    at = k.kept(st["seg_state"], open_rows, doc & sealed)
    _put(st["seg_state"], at, k.i32[2])
    _put(st["seg_stime"], at, t_c)
    at = k.kept(st["seg_state"], fresh_rows, doc & sealed)
    _put(st["seg_state"], at, k.i32[1])
    _put(st["seg_cls"], at, k.cls_ids.expand(V, C))
    _put(st["seg_ctime"], at, t_c)
    st["open_sid"].copy_(torch.where(doc & sealed, free_ids, sids))
    used_pad = (free_ids == pad) & ((took2 > 0) | sealed)
    st["overflow"] = st["overflow"] + used_pad.sum(1, dtype=torch.int32) * do
    st["class_gc"] = st["class_gc"] + per_cls * doc
    _gc_release(cfg, st, h, do, k)


def _gc_once_legacy(cfg: TorchSimConfig, st: dict, victims, do, k: Consts):
    """JAX's ``_gc_once_legacy``, in place where ``do``: after the shared
    head, an unrolled rewrite per class slot. Each class's live blocks are
    appended as a batch to its open segment and then to its fresh row, one
    scatter per JAX ``.at[...]`` and in JAX's order, each class reading the
    fill counts and open rows that the classes before it left. A padded class
    slot (>= ``p_classes``) moves no block and never seals or promotes.
    Unlike `_gc_once`, whose single scatter reads every class's fill up
    front, this stays defined when several classes' fresh row is the pad
    row: the fused rewrite's oracle, and its difference in that corner."""
    s, C, pad = cfg.segment_size, cfg.n_class_slots, cfg.pad_row
    doc = do[:, None]
    t = st["t"]
    h = _gc_bookkeeping(cfg, st, victims, do, k)
    at_lba = k.lba0[:, None] + h.lba_v
    for c in range(C):
        cls_active = st["p_classes"] > c
        mask = h.classes == c
        ranks = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
        count = mask.sum(1, dtype=torch.int32)
        sid = st["open_sid"][:, c].clone()
        srow = k.row0 + sid
        n0 = st["seg_n"].view(-1)[srow]
        room = torch.clamp(s - n0, min=0)
        _put(st["seg_ctime"], k.kept(st["seg_ctime"], srow, do & (n0 == 0) & (count > 0)), t)
        first = ranks < room[:, None]
        fresh = h.free_ids[:, c]
        frow = k.row0 + fresh
        for row, part, off, dst in ((srow, mask & first & doc, n0[:, None] + ranks, sid),
                                    (frow, mask & ~first & doc, ranks - room[:, None],
                                     fresh.to(torch.int32))):
            at = k.kept(st["seg_lba"], row[:, None] * s + off, part & (off < s))
            _put(st["seg_lba"], at, h.lba_v)
            _put(st["seg_utime"], at, h.utime_v)
            _put(st["seg_valid"], at, k.true)
            at = k.kept(st["loc_seg"], at_lba, part)
            _put(st["loc_seg"], at, dst[:, None].expand_as(at))
            _put(st["loc_off"], at, off)
        took1 = torch.minimum(count, room) * do
        took2 = count * do - took1
        _add(st["seg_n"], srow, took1)
        _add(st["seg_nvalid"], srow, took1)
        _add(st["seg_n"], frow, took2)
        _add(st["seg_nvalid"], frow, took2)
        _add(st["class_gc"], k.cls0 + c, count * do)
        sealed = cls_active & (st["seg_n"].view(-1)[srow] >= s) & do
        at = k.kept(st["seg_state"], srow, sealed)
        _put(st["seg_state"], at, k.i32[2])
        _put(st["seg_stime"], at, t)
        at = k.kept(st["seg_state"], frow, sealed)
        _put(st["seg_state"], at, k.i32[1])
        _put(st["seg_cls"], at, k.cls_ids[c])
        _put(st["seg_ctime"], at, t)
        st["open_sid"][:, c] = torch.where(sealed, fresh.to(torch.int32), sid)
        used_pad = (fresh == pad) & ((took2 > 0) | sealed)
        st["overflow"] = st["overflow"] + used_pad.to(torch.int32)
    _gc_release(cfg, st, h, do, k)


def _gc_deferred(cfg: TorchSimConfig, st: dict, k: Consts):
    """idle_window's defer predicate per volume, evaluated on every GC
    iteration: skip GC while the write-density EWMA is above
    ``idle_density``, unless the free rows have fallen below the watermark.
    False for the other schedules."""
    idle = st["p_gcsched"] == GCSCHED_IDS["idle_window"]
    hot = st["lat_dens"] > k.f32["idle_density"]
    free_rows = (st["seg_state"] == 0).sum(1, dtype=torch.int32)
    return idle & hot & (free_rows >= cfg.watermark_rows)


def _charge_gc(cfg: TorchSimConfig, st: dict, active, k: Consts):
    """Move the GC debt onto the busy horizon at the end of a step (in
    place): all of it, or for rate_limited volumes at most ``gc_rate *
    gc_block_cost``, the rest carried. A volume on a pad step (``active``
    False) is left as it was. Conservation: ``lat_charged + lat_debt ==
    gc_writes * gc_block_cost``."""
    debt = st["lat_debt"]
    limited = st["p_gcsched"] == GCSCHED_IDS["rate_limited"]
    charge = torch.where(limited, torch.minimum(debt, k.f32["charge_cap"]), debt)
    busy = torch.maximum(st["lat_busy"], st["lat_now"]) + charge
    st["lat_busy"] = _keep(busy, st["lat_busy"], active)
    st["lat_debt"] = _keep(debt - charge, debt, active)
    st["lat_charged"] = _keep(st["lat_charged"] + charge, st["lat_charged"], active)


def _select_victims_fleet(st):
    return segment_select_batch(st["seg_n"], st["seg_nvalid"], st["seg_stime"],
                                st["seg_state"], st["t"], st["p_selector"])[0]


def _select_victim_single(st):
    idx, _ = segment_select(st["seg_n"][0], st["seg_nvalid"][0], st["seg_stime"][0],
                            st["seg_state"][0], st["t"][0], st["p_selector"][0])
    return idx.reshape(1)


def fleet_gc_tick(cfg: TorchSimConfig, st: dict, k: Consts, step_active=None, select=None,
                  stats: ReplayStats | None = None):
    """GC ticks over a batched state, in place, while any volume's garbage
    proportion exceeds its ``p_gp`` (at most ``cfg.max_gc_per_step`` ticks).
    Each tick is one GC operation (numpy's ``run_gc_once``): it selects a
    victim per volume (``select``; the batched segsel kernel by default) and
    rewrites it where the volume triggers, then, for ``cfg.gc_batch_segments``
    = k > 1, selects and rewrites again, up to k victims, until a volume's
    round finds no eligible row. A later round ranks only the rows sealed
    at the operation's start: a row that a rewrite seals may hold garbage
    (blocks of its open segment invalidated before the operation), and
    numpy's ``GCPolicy.select`` ranks the sealed rows once, at the start.
    No user write lands inside an operation, so no other score moves, and
    the victims are the k eligible rows of highest score at its start, ties
    to the lower row. Volumes below threshold, stalled (no eligible victim
    in an operation's first round) or on a pad step (``step_active`` False)
    are left as they were, and so are idle_window volumes while
    `_gc_deferred`. Per volume this is the single-volume GC loop's iteration
    sequence, so fleets match single runs. One host sync per tick."""
    select = select or _select_victims_fleet
    stalled = torch.zeros_like(st["t"], dtype=torch.bool)
    for i in range(cfg.max_gc_per_step):
        need = (_gp(st) > st["p_gp"]) & ~stalled
        if k.idle_window:
            need = need & ~_gc_deferred(cfg, st, k)
        if step_active is not None:
            need = need & step_active
        if stats is not None:
            stats.host_syncs += 1
        if not bool(need.any()):      # the host sync of this tick iteration
            break
        if stats is not None:
            stats.tick_iterations += 1
            stats.gc_ticks += 1 if i == 0 else 0
        victims = select(st)
        go = need & (victims >= 0)
        sealed0 = st["seg_state"] == 2 if cfg.gc_batch_segments > 1 else None
        _gc_once(cfg, st, victims, go, k)
        stalled = stalled | (need & (victims < 0))
        for _ in range(1, cfg.gc_batch_segments):
            victims = select({**st, "seg_state": torch.where(sealed0, st["seg_state"], 0)})
            go = go & (victims >= 0)
            _gc_once(cfg, st, victims, go, k)


def legacy_gc(cfg: TorchSimConfig, st: dict, k: Consts, step_active=None, select=None,
              stats: ReplayStats | None = None):
    """The legacy GC loop (JAX's ``_maybe_gc_legacy``, vmapped over the
    fleet), in place: a victim per volume is selected at loop entry on every
    user write, GC or not (``select``; the batched segsel kernel by default),
    and a volume runs while its garbage proportion exceeds its ``p_gp``, it
    has a victim and it has run fewer than ``cfg.max_gc_per_step`` rewrites;
    after each rewrite its victim is selected again. A volume that stops
    (``running`` only goes from True to False) keeps its state, and so does
    one on a pad step (``step_active`` False). One host sync per iteration,
    for ``running.any()``."""
    if cfg.gc_batch_segments != 1:
        raise ValueError("the legacy GC engine takes one victim per GC operation")
    select = select or _select_victims_fleet
    victims = select(st)
    running = (_gp(st) > st["p_gp"]) & (victims >= 0)
    if step_active is not None:
        running = running & step_active
    for i in range(cfg.max_gc_per_step):
        if stats is not None:
            stats.host_syncs += 1
        if not bool(running.any()):   # the host sync of this iteration
            break
        if stats is not None:
            stats.tick_iterations += 1
            stats.gc_ticks += 1 if i == 0 else 0
        _gc_once_legacy(cfg, st, victims, running, k)
        victims = select(st)
        running = running & (_gp(st) > st["p_gp"]) & (victims >= 0)


def fleet_step(cfg: TorchSimConfig, st: dict, lbas, masked: bool, k: Consts, select=None,
               stats: ReplayStats | None = None, nxt=None, sfs_refresh=None):
    """One user write per volume, then the fleet's GC (the tick engine's
    `fleet_gc_tick`, or `legacy_gc` under ``cfg.gc_engine="legacy"``) and,
    with the timing model, the GC time's charge (in place). With
    ``masked``, pad entries (-1) of ``lbas`` are exact no-ops, the charge
    included. ``nxt`` and ``sfs_refresh``: see `_user_write`."""
    active = lbas >= 0 if masked else None
    _user_write(cfg, st, lbas, active, k, nxt, sfs_refresh)
    gc = legacy_gc if cfg.gc_engine == "legacy" else fleet_gc_tick
    gc(cfg, st, k, active, select, stats)
    if cfg.timing:
        _charge_gc(cfg, st, active, k)
    if stats is not None:
        stats.steps += 1


def _sfs_refresh_steps(cfg: TorchSimConfig, st: dict, trace, k: Consts) -> set:
    """The steps at which some sfs volume's write counter reaches
    ``cfg.sfs_resample`` (its quantile bounds may refresh), known on the host
    from the counters at the start and the trace's real writes, so the step
    engine needs no host sync per step to skip the refresh elsewhere."""
    sid = SCHEME_IDS["sfs"]
    if sid not in k.stateful:
        return set()
    vols = torch.nonzero(k.member[sid])[:, 0]
    real = (trace[vols] >= 0).cpu().numpy()
    writes = np.cumsum(real, axis=1)
    since0 = st["sch_sfs_since"][vols].cpu().numpy().astype(np.int64)
    # the first tick after max(R - since0, 1) writes, then one every R
    first = np.maximum(cfg.sfs_resample - since0, 1)[:, None]
    tick = real & (writes >= first) & ((writes - first) % max(cfg.sfs_resample, 1) == 0)
    return set(np.nonzero(tick.any(axis=0))[0].tolist())


def step_replay(cfg: TorchSimConfig, st: dict, trace, stats: ReplayStats | None = None,
                select=None, nxt=None):
    """The step engine: replay the (V, T) int32 ``trace`` (-1: a pad step)
    through ``st`` in place, one lockstep step at a time. The plain version of
    the replay kernel (`kernels.replay`). ``nxt`` is fk's (V, T) int32
    next-write stream; None makes it from the trace (`annotate`)."""
    V, T = trace.shape
    masked = bool((trace < 0).any())
    lbas_tv = trace.t().contiguous().to(torch.int64)
    k = Consts(cfg, V, st["t"].device, st["p_scheme"], st["p_gcsched"])
    nxt_vt = _next_writes(st, trace, nxt)
    nxt_tv = None if nxt_vt is None else nxt_vt.t().contiguous()
    refresh = _sfs_refresh_steps(cfg, st, trace, k)
    for i in range(T):
        fleet_step(cfg, st, lbas_tv[i], masked, k, select, stats,
                   None if nxt_tv is None else nxt_tv[i], i in refresh)
    return st


def _next_writes(st: dict, trace, nxt=None):
    """fk's (V, T) int32 next-write stream on the trace's device, contiguous,
    for both engines: ``nxt`` as given, or made from the trace
    (`annotate.fleet_annotations`) when none is; None when no volume runs fk
    (nothing reads it then, and nothing is made)."""
    schemes = torch.unique(st["p_scheme"]).tolist()
    if not any(SCHEME_REQUIRES_FUTURE[int(sid)] for sid in schemes):
        return None
    if nxt is None:
        lbas, scheme_ids = trace.cpu().numpy(), st["p_scheme"].cpu().numpy()
        with span("next_writes"):
            nxt = fleet_annotations(lbas, scheme_ids)
    return coerce_fleet_annotations(nxt, tuple(trace.shape), trace.device).contiguous()


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choices: {ENGINES}")


def _replay(cfg, st, trace, stats, engine, select, nxt=None):
    """The replay kernel for a state on the card under ``engine="replay"``,
    with fk's next-write stream made as the step engine makes it
    (`_next_writes`); else its plain version, the step engine (the only one
    on the CPU)."""
    if engine == "replay" and trace.is_cuda:
        replay_kernel(cfg, st, trace, stats, _next_writes(st, trace, nxt))
    else:
        step_replay(cfg, st, trace, stats, select, nxt)
    return st


def run(cfg: TorchSimConfig, trace, policy: dict | None = None, device="cuda",
        state: dict | None = None, stats: ReplayStats | None = None,
        engine: str = "replay", nxt=None) -> dict:
    """Replay one volume's trace (the counterpart of ``jaxsim._run``),
    starting from ``init_state`` or from ``state``; returns the final state
    with a leading volume axis of 1. ``engine="replay"`` runs the replay
    kernel with one volume; ``engine="step"`` the step engine, with victims
    from `segment_select`. ``nxt``: fk's next-write indices of the trace's
    writes (None: made from the trace)."""
    _check_engine(engine)
    dev = resolve_device(device)
    trace = np.asarray(trace, dtype=np.int32)
    with span("check_lbas"):
        if trace.ndim != 1 or (trace < 0).any() or (trace >= cfg.n_lbas).any():
            raise ValueError(f"trace must be 1-D LBAs in [0, {cfg.n_lbas})")
    st = own_state(init_state(cfg, policy, dev) if state is None else state)
    if st["t"].shape != (1,):
        raise ValueError("a single-volume state has a leading volume axis of 1")
    return _replay(cfg, st, torch.from_numpy(trace[None]).to(dev), stats, engine,
                   _select_victim_single, None if nxt is None else np.asarray(nxt)[None])


def simulate(trace, cfg: TorchSimConfig, policy: dict | None = None, device="cuda",
             engine: str = "replay") -> dict:
    """Replay ``trace`` on one volume; returns the summary of ``jaxsim.simulate_jax``."""
    st = state_to_numpy(run(cfg, trace, policy, device, engine=engine))
    return _summary(cfg, {k: x[0] for k, x in st.items()})


# -- fleet mode -----------------------------------------------------------------

def pad_fleet(traces) -> np.ndarray:
    """Stack 1-D traces of unequal length into a (V, T_max) int32 matrix
    padded with -1 (replayed as masked no-op steps)."""
    traces = [np.asarray(t, dtype=np.int32) for t in traces]
    T = max((len(t) for t in traces), default=0)
    out = np.full((len(traces), T), -1, dtype=np.int32)
    for i, t in enumerate(traces):
        out[i, : len(t)] = t
    return out


def coerce_fleet(traces) -> np.ndarray:
    """Normalize a list of 1-D traces or a (V, T) matrix to padded int32."""
    padded = np.asarray(traces, dtype=np.int32) if isinstance(traces, np.ndarray) \
        else pad_fleet(traces)
    if padded.ndim != 2:
        raise ValueError("traces must be a list of 1-D traces or a (V, T) matrix")
    return padded


def broadcast_policies(cfg: TorchSimConfig, n_volumes: int) -> dict:
    """(V,) policy arrays that replicate ``cfg``'s knobs."""
    return {k: np.full(n_volumes, v) for k, v in default_policy(cfg).items()}


def _check_lbas(cfg: TorchSimConfig, trace: torch.Tensor) -> None:
    """Raise unless every LBA of the (V, T) ``trace`` tensor lies below
    ``cfg.n_lbas``, checked where the trace lies: one reduction (no (V, T)
    temporary) and its one-element verdict copied to the host without a
    wait, both enqueued before the ``check_lbas`` span, which holds only the
    host's wait for that verdict."""
    if not trace.numel():
        return
    # a NumPy view of the verdict's host buffer, read once the copy is done
    over = (trace.amax() >= cfg.n_lbas).to("cpu", non_blocking=True).numpy()
    ready = None
    if trace.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(trace.device))
    with span("check_lbas"):
        if ready is not None:
            ready.synchronize()
        refused = bool(over)
    if refused:
        raise ValueError(f"trace LBAs must lie in [0, {cfg.n_lbas})")


def run_fleet(cfg: TorchSimConfig, traces, policies: dict | None = None, device="cuda",
              state: dict | None = None, stats: ReplayStats | None = None,
              engine: str = "replay", nxts=None) -> dict:
    """Replay V volumes in lockstep (the counterpart of ``jaxsim._run_fleet``)
    and return the final batched state. ``traces`` is a list of 1-D traces
    (unequal lengths are padded with -1) or a padded (V, T) matrix;
    ``policies`` optionally gives (V,) arrays per policy key. ``engine``:
    ``"replay"`` (the replay kernel) or ``"step"`` (the step engine, victims
    from `segment_select_batch`). ``nxts``: fk's (V, T) next-write indices
    (None: made from the traces, as ``jaxsim.fleet_annotations`` makes
    them). The trace is uploaded as it is (on the CPU the tensor shares the
    caller's array, which no engine writes) and its LBAs are checked there
    (`_check_lbas`) before any state is made."""
    _check_engine(engine)
    dev = resolve_device(device)
    padded = coerce_fleet(traces)
    V = padded.shape[0]
    if not padded.flags.c_contiguous:
        trace_counts["trace_copy_bytes"] += padded.nbytes
        padded = np.ascontiguousarray(padded)
    trace = torch.from_numpy(padded).to(dev)
    _check_lbas(cfg, trace)
    if state is None:
        state = init_state(cfg, broadcast_policies(cfg, V) if policies is None else policies,
                           dev)
    elif policies is not None:
        raise ValueError("pass policies or a state, not both (the state carries its policy)")
    st = own_state(state)
    if st["t"].shape != (V,):
        raise ValueError(f"state holds {st['t'].shape[0]} volumes, traces {V}")
    return _replay(cfg, st, trace, stats, engine, _select_victims_fleet, nxts)


def hist_quantile(hist, q: float, write_cost: float = 1.0) -> float:
    """The q-quantile latency of a quarter-octave histogram: its bucket's
    lower edge, so an all-bucket-0 histogram gives ``write_cost`` exactly."""
    hist = np.asarray(hist)
    total = int(hist.sum())
    if total == 0:
        return 0.0
    target = int(np.ceil(q * total))
    idx = int(np.searchsorted(np.cumsum(hist), target))
    return float(write_cost * 2.0 ** (idx / LAT_BUCKETS_PER_OCTAVE))


def latency_summary(cfg: TorchSimConfig, st: dict) -> dict:
    """Foreground-latency figures of one volume's final state (numpy)."""
    user = int(st["user_writes"])
    hist = np.asarray(st["lat_hist"])
    return {
        "p50": hist_quantile(hist, 0.50, cfg.write_cost),
        "p99": hist_quantile(hist, 0.99, cfg.write_cost),
        "max": float(st["lat_max"]),
        "mean": float(st["lat_sum"]) / max(user, 1),
        "total": float(st["lat_sum"]),
        "gc_time_charged": float(st["lat_charged"]),
        "gc_debt": float(st["lat_debt"]),
        "write_cost": cfg.write_cost,
        "hist": hist.tolist(),
    }


def summary_keys(cfg: TorchSimConfig) -> tuple:
    """The state keys `_summary` reads of a volume under ``cfg``."""
    keys = ("p_scheme", "p_selector", "p_gp", "p_gcsched", "user_writes", "gc_writes",
            "reclaimed", "overflow", "ell", "class_user", "class_gc")
    if cfg.timing:
        keys += ("lat_hist", "lat_max", "lat_sum", "lat_charged", "lat_debt")
    if cfg.fifo_occupancy:
        keys += ("fifo_peak", "fifo_last", "last_uw")
    return keys


def _summary(cfg: TorchSimConfig, st: dict) -> dict:
    """Summary of one volume's final state (numpy arrays, no volume axis),
    from the keys `summary_keys` names."""
    user = int(st["user_writes"])
    gc_writes = int(st["gc_writes"])
    overflow = int(st["overflow"])
    out = {
        "scheme": SCHEME_NAMES[int(st["p_scheme"])],
        "selector": SELECTOR_NAMES[int(st["p_selector"])],
        "gp_threshold": float(st["p_gp"]),
        "gcsched": GCSCHED_NAMES[int(st["p_gcsched"])],
        "user_writes": user,
        "gc_writes": gc_writes,
        "wa": (user + gc_writes) / user if user else 1.0,
        "reclaimed": int(st["reclaimed"]),
        "overflow": overflow,
        "free_exhausted": overflow,
        "degraded": overflow > 0,   # pad-row accounting: WA is logical past here
        "ell": float(st["ell"]),
        "class_user_writes": np.asarray(st["class_user"]).tolist(),
        "class_gc_writes": np.asarray(st["class_gc"]).tolist(),
    }
    if cfg.timing:
        out["latency"] = latency_summary(cfg, st)
    if cfg.fifo_occupancy:
        # numpy SimResult's Exp#5 fields: None where no sample was taken
        peak, last = int(st["fifo_peak"]), int(st["fifo_last"])
        out["fifo_occupancy_peak"] = None if peak < 0 else peak
        out["fifo_occupancy_last"] = None if last < 0 else last
        out["wss_unique_lbas"] = int((np.asarray(st["last_uw"]) > -BIG).sum())
    return out


def summarize_fleet(cfg: TorchSimConfig, st: dict, n_volumes: int) -> dict:
    """Per-volume summaries and the fleet aggregate from a batched state
    (tensors, or numpy arrays)."""
    if isinstance(st["t"], torch.Tensor):
        st = state_to_numpy(st)
    summary_counts["fleet_summaries"] += 1
    summary_counts["summary_bytes"] += n_volumes * sum(st[k][:1].nbytes for k in summary_keys(cfg))
    with span("summaries"):
        vols = [_summary(cfg, {k: x[i] for k, x in st.items()}) for i in range(n_volumes)]
        user = sum(r["user_writes"] for r in vols)
        gc = sum(r["gc_writes"] for r in vols)
        overflow = sum(r["overflow"] for r in vols)
        fleet = {
            "n_volumes": n_volumes,
            "user_writes": user,
            "gc_writes": gc,
            "wa": (user + gc) / max(user, 1),
            "overflow": overflow,
            "free_exhausted": overflow,
            "degraded": overflow > 0,
            "per_volume_wa": [r["wa"] for r in vols],
        }
        if cfg.timing:
            # fleet quantiles from the merged histogram (per-volume p99s do not average)
            hist = np.asarray(st["lat_hist"])[:n_volumes].sum(axis=0)
            fleet["latency"] = {
                "p50": hist_quantile(hist, 0.50, cfg.write_cost),
                "p99": hist_quantile(hist, 0.99, cfg.write_cost),
                "max": max((r["latency"]["max"] for r in vols), default=0.0),
                "mean": sum(r["latency"]["total"] for r in vols) / max(user, 1),
                "gc_debt": sum(r["latency"]["gc_debt"] for r in vols),
            }
    return {"volumes": vols, "fleet": fleet}


def simulate_fleet(traces, cfg: TorchSimConfig, policies: dict | None = None,
                   device="cuda", engine: str = "replay") -> dict:
    """Replay N independent volumes in lockstep; returns
    ``{"volumes": [per-volume summary, ...], "fleet": aggregate}``, each
    volume's result equal to a single-volume run of its trace."""
    padded = coerce_fleet(traces)
    st = run_fleet(cfg, padded, policies, device, engine=engine)
    return summarize_fleet(cfg, st, padded.shape[0])
