"""The nine stateful placement schemes on the step engine.

Counterparts of the JAX package's triples in ``placement/jax_schemes.py``:
the per-LBA-table schemes fk (the future-knowledge bound), dac, ml and sfs,
and the shared-classifier schemes eti, mq, sfr, fadac and warcip, whose
arithmetic is the torch twin of ``temperature_shared``. Each keeps its
tables in the state's ``sch_<name>_*`` keys (a leading volume axis V; every
volume carries every scheme's keys, so one key set serves a mixed fleet)
and has three parts:

- ``spec(cfg)``: its keys' per-volume shape, dtype and initial value;
- ``user(cfg, st, w)``: the (V,) classes of one user write per volume
  (`UserWrite`), writing its own keys in place only where ``w.keep``;
- ``gc``: the (V, s) classes of the GC victims' slots (`GcVictims`),
  writing its own keys only where ``g.keep`` and the slot is live; or, for
  the schemes whose GC rewrites all go to one class, that class.

A branch computes over every volume of the fleet and the dispatch
(`user_classes`, `gc_classes`) keeps its classes for the scheme's own
volumes, as JAX's ``lax.switch`` under ``vmap`` (a select) does. Its
masked writes go through the spare element of `inplace.put`. This module is
the plain version of the replay kernel's stateful instance
(``kernels/csrc/stateful_ops.cuh``), which follows its formulas op by op.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..inplace import Consts, put
from . import temperature_shared as ts
from .schemes import NOBIT, SCHEME_IDS

I32, F32 = torch.int32, torch.float32
N_CLS = 6                 # classes of fk, dac, ml and sfs


class UserWrite(NamedTuple):
    """One user write per volume: ``lba`` (V,) int64 in range, ``t`` (V,)
    int32 the volume's time before the write, ``nxt`` (V,) int32 the next
    write's index (fk), ``keep`` (V,) bool where the branch may write, and
    ``sfs_refresh``: whether some sfs volume refreshes its quantile bounds
    at this step (None: ask the device, a host sync)."""

    lba: torch.Tensor
    t: torch.Tensor
    nxt: torch.Tensor | None
    keep: torch.Tensor
    k: Consts
    sfs_refresh: bool | None = None


class GcVictims(NamedTuple):
    """Each volume's GC victim: its slots' ``lba`` (V, s) int64 and
    ``valid`` (V, s) bool, the time ``t`` (V,) int32, and ``keep`` (V,)
    bool where the victim is rewritten and the branch may write."""

    lba: torch.Tensor
    valid: torch.Tensor
    t: torch.Tensor
    keep: torch.Tensor
    k: Consts


@dataclasses.dataclass(frozen=True)
class Stateful:
    spec: Callable
    user: Callable
    gc: Callable | int


def _flat(w, table):
    """Flat index of each volume's entry ``w.lba`` in a (V, n_lbas) table."""
    return w.k.base(table.shape[1]) + w.lba


def _gc_at(g, table):
    """Flat indices of the victims' live slots in a (V, n_lbas) table where
    ``g.keep``; the spare element elsewhere (dead slots are dropped)."""
    flat = g.k.base(table.shape[1])[:, None] + g.lba
    return g.k.kept(table, flat, g.valid & g.keep[:, None])


# -- fk: future-knowledge oracle -------------------------------------------------

def _fk_spec(cfg):
    return {"sch_fk_bit": ((cfg.n_lbas,), I32, NOBIT)}


def _fk_class(cfg, remaining, never):
    """ceil(remaining lifespan / segment size) - 1 in 0..5; 5 for no next write."""
    s = cfg.segment_size
    by_life = ((remaining.clamp(min=1) + s - 1) // s - 1).clamp(0, N_CLS - 1)
    return torch.where(never, N_CLS - 1, by_life).to(I32)


def _fk_user(cfg, st, w):
    bit = st["sch_fk_bit"]
    nxt = w.nxt if w.nxt is not None else torch.full_like(w.t, NOBIT)
    put(bit, w.k.kept(bit, _flat(w, bit), w.keep), nxt)
    return _fk_class(cfg, nxt - w.t, nxt >= NOBIT)


def _fk_gc(cfg, st, g):
    b = torch.gather(st["sch_fk_bit"], 1, g.lba)
    return _fk_class(cfg, b - g.t[:, None], b >= NOBIT)


# -- dac: region ladder ----------------------------------------------------------

def _dac_spec(cfg):
    return {"sch_dac_region": ((cfg.n_lbas,), I32, 0)}


def _dac_user(cfg, st, w):
    region = st["sch_dac_region"]
    flat = _flat(w, region)
    r = (region.view(-1)[flat] + 1).clamp(1, N_CLS - 1)
    put(region, w.k.kept(region, flat, w.keep), r)
    return N_CLS - 1 - r


def _dac_gc(cfg, st, g):
    region = st["sch_dac_region"]
    r = (torch.gather(region, 1, g.lba) - 1).clamp(0, N_CLS - 1)
    put(region, _gc_at(g, region), r)
    return N_CLS - 1 - r


# -- ml: MultiLog ----------------------------------------------------------------

def _ml_spec(cfg):
    return {"sch_ml_count": ((cfg.n_lbas,), I32, 0), "sch_ml_level": ((cfg.n_lbas,), I32, 0)}


def _ml_user(cfg, st, w):
    count, level = st["sch_ml_count"], st["sch_ml_level"]
    flat = _flat(w, count)
    c = count.view(-1)[flat] + 1
    # floor(log2(count)) clipped to 0..5 (JAX: 31 - clz), as a comparison ladder
    lvl = ts._ladder(c, (2, 4, 8, 16, 32))
    at = w.k.kept(count, flat, w.keep)
    put(count, at, c)
    put(level, at, lvl)
    return N_CLS - 1 - lvl


def _ml_gc(cfg, st, g):
    level = st["sch_ml_level"]
    lvl = (torch.gather(level, 1, g.lba) - 1).clamp(0, N_CLS - 1)
    put(level, _gc_at(g, level), lvl)
    return N_CLS - 1 - lvl


# -- sfs: hotness quantile groups ------------------------------------------------

def _sfs_spec(cfg):
    n = (cfg.n_lbas,)
    return {"sch_sfs_count": (n, I32, 0), "sch_sfs_first": (n, I32, -1),
            "sch_sfs_since": ((), I32, 0), "sch_sfs_bounds": ((N_CLS - 1,), F32, 0.0),
            "sch_sfs_ready": ((), torch.bool, False)}


def _sfs_hotness(count, first, t):
    age = (t - first).clamp(min=1).to(F32)
    return count.to(F32) / age


def searchsorted_left(bounds, h):
    """jnp.searchsorted(bounds, h) per volume (``bounds`` (V, m), ``h`` (V,
    ...)): JAX's default binary search of ceil(log2(m + 1)) halvings, side
    "left", step for step, so the result is JAX's also where float rounding
    leaves the quantile bounds out of order."""
    V, m = bounds.shape
    q = h.reshape(V, -1)
    mid = m // 2
    left = q <= bounds[:, mid:mid + 1]
    low, high = torch.where(left, 0, mid), torch.where(left, mid, m)
    for _ in range(int(np.ceil(np.log2(m + 1))) - 1):
        mid = (low + high) // 2
        left = q <= torch.gather(bounds, 1, mid)
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    return high.reshape(h.shape)


def _sfs_class(st, h):
    cls = (N_CLS - 1 - searchsorted_left(st["sch_sfs_bounds"], h)).clamp(0, N_CLS - 1)
    ready = st["sch_sfs_ready"].view((-1,) + (1,) * (h.dim() - 1))
    return torch.where(ready, cls, 0).to(I32)


# the quantile positions' factors i / 6 as XLA folds them: i times the
# float32 reciprocal of 6, each product rounded to float32
_SFS_Q = tuple(float(np.float32(i) * (np.float32(1.0) / np.float32(N_CLS)))
               for i in range(1, N_CLS))


def _sfs_bounds(count, first, t, seen, kk):
    """Each volume's quantiles of the seen LBAs' hotness, at positions
    ``i / 6 * (k - 1)`` with linear interpolation (numpy's np.quantile).
    The arithmetic is that of the JAX fleet engine (``jaxsim._run_fleet``)
    as XLA compiles it for the CPU: ``i / 6`` is folded to ``i * f32(1/6)``,
    and ``hs[lo] * (1 - frac) + hs[hi] * frac`` becomes
    ``fma(hs[hi], frac, hs[lo] * (1 - frac))`` (`_fma`). XLA compiles the
    single-volume ``jaxsim._run`` otherwise, as ``i * ((k - 1) * f32(1/6))``
    and ``fma(hs[lo], 1 - frac, hs[hi] * frac)``, so its bounds can differ
    from its own fleet of one by an ulp; the port, one engine for both,
    follows the fleet."""
    h = torch.where(seen, _sfs_hotness(count, first, t[:, None]), float("inf"))
    hs = torch.sort(h, dim=1).values
    q = ts._const(_SFS_Q, hs) * (kk - 1).clamp(min=0).to(F32)[:, None]
    lo, hi = torch.floor(q), torch.ceil(q)
    frac = q - lo
    return _fma(torch.gather(hs, 1, hi.long()), frac,
                torch.gather(hs, 1, lo.long()) * (1.0 - frac))


def _fma(a, b, c):
    """float32 ``a * b + c`` with one rounding: the product of two float32
    values is exact in float64, so only the float64 sum and the cast round
    (the same on the CPU and the card; the two roundings differ from one
    only when the float64 sum lands exactly halfway between two float32
    values, which these magnitudes make vanishingly rare)."""
    return (a.double() * b.double() + c.double()).to(F32)


def _sfs_user(cfg, st, w):
    count, first = st["sch_sfs_count"], st["sch_sfs_first"]
    flat = _flat(w, count)
    f0 = first.view(-1)[flat]
    f1 = torch.where(f0 < 0, w.t, f0)
    c1 = count.view(-1)[flat] + 1
    at = w.k.kept(count, flat, w.keep)
    put(first, at, f1)
    put(count, at, c1)
    since = st["sch_sfs_since"] + 1
    tick = since >= cfg.sfs_resample
    refresh = w.sfs_refresh
    if refresh is None:
        refresh = bool((tick & w.keep).any())
    if refresh:
        seen = first >= 0
        kk = seen.sum(1, dtype=I32)
        do = tick & (kk >= N_CLS) & w.keep
        st["sch_sfs_bounds"] = torch.where(do[:, None], _sfs_bounds(count, first, w.t, seen, kk),
                                           st["sch_sfs_bounds"])
        st["sch_sfs_ready"] = st["sch_sfs_ready"] | do
    st["sch_sfs_since"] = torch.where(w.keep, torch.where(tick, 0, since), st["sch_sfs_since"])
    return _sfs_class(st, _sfs_hotness(c1, f1, w.t))


def _sfs_gc(cfg, st, g):
    h = _sfs_hotness(torch.gather(st["sch_sfs_count"], 1, g.lba),
                     torch.gather(st["sch_sfs_first"], 1, g.lba), g.t[:, None])
    return _sfs_class(st, h)


# -- eti: per-extent counters, lazy periodic halving -----------------------------

def _eti_spec(cfg):
    n_ext = (-(-cfg.n_lbas // ts.ETI_EXTENT_BLOCKS),)
    return {"sch_eti_count": (n_ext, I32, 0), "sch_eti_last": (n_ext, I32, 0)}


def _eti_user(cfg, st, w):
    count, last = st["sch_eti_count"], st["sch_eti_last"]
    e = w.lba // ts.ETI_EXTENT_BLOCKS
    flat = w.k.base(count.shape[1]) + e
    before = w.t // ts.ETI_DECAY_EVERY          # epochs before this write
    after = (w.t + 1) // ts.ETI_DECAY_EVERY     # after its decay tick
    c_new = ts.eti_fold(count.view(-1)[flat], last.view(-1)[flat], before) + 1
    at = w.k.kept(count, flat, w.keep)
    put(count, at, c_new)
    put(last, at, before)
    return ts.eti_user_class(count, last, after, e)


# -- mq: log2(freq) queue levels with expiry demotion ----------------------------

def _mq_spec(cfg):
    n = (cfg.n_lbas,)
    return {"sch_mq_freq": (n, I32, 0), "sch_mq_level": (n, I32, 0), "sch_mq_expire": (n, I32, 0)}


def _mq_user(cfg, st, w):
    freq, level, expire = st["sch_mq_freq"], st["sch_mq_level"], st["sch_mq_expire"]
    flat = _flat(w, freq)
    f_new = freq.view(-1)[flat] + 1
    cls, lvl = ts.mq_user(f_new, level.view(-1)[flat], expire.view(-1)[flat], w.t)
    at = w.k.kept(freq, flat, w.keep)
    put(freq, at, f_new)
    put(level, at, lvl)
    put(expire, at, w.t + 4 * cfg.segment_size)
    return cls


# -- sfr: sequentiality / frequency / recency score ------------------------------

def _sfr_spec(cfg):
    n_ch = (-(-cfg.n_lbas // ts.SFR_CHUNK_BLOCKS),)
    return {"sch_sfr_freq": (n_ch, F32, 0.0), "sch_sfr_last": (n_ch, I32, ts.SFR_LAST_INIT),
            "sch_sfr_prev": ((), I32, -2)}


def _sfr_user(cfg, st, w):
    freq, last, prev = st["sch_sfr_freq"], st["sch_sfr_last"], st["sch_sfr_prev"]
    flat = w.k.base(freq.shape[1]) + w.lba // ts.SFR_CHUNK_BLOCKS
    seq_f = (w.lba == prev + 1).to(F32)
    dt = (w.t - last.view(-1)[flat]).clamp(min=0)
    f_new = ts.sfr_freq_update(freq.view(-1)[flat])
    at = w.k.kept(freq, flat, w.keep)
    put(freq, at, f_new)
    put(last, at, w.t)
    st["sch_sfr_prev"] = torch.where(w.keep, w.lba.to(I32), prev)
    return ts.sfr_class(ts.sfr_score(f_new, dt, seq_f))


# -- fadac: fading counters, lazy half-life decay --------------------------------

def _fadac_spec(cfg):
    n_ch = (-(-cfg.n_lbas // ts.FADAC_CHUNK_BLOCKS),)
    return {"sch_fadac_count": (n_ch, I32, 0), "sch_fadac_last": (n_ch, I32, 0)}


def _fadac_user(cfg, st, w):
    count, last = st["sch_fadac_count"], st["sch_fadac_last"]
    flat = w.k.base(count.shape[1]) + w.lba // ts.FADAC_CHUNK_BLOCKS
    cnt = ts.fadac_fold(count.view(-1)[flat], last.view(-1)[flat], w.t) + 1
    at = w.k.kept(count, flat, w.keep)
    put(count, at, cnt)
    put(last, at, w.t)
    return ts.fadac_class(cnt)


def _fadac_gc(cfg, st, g):
    # read-only folds; dead slots read stale (in-range) chunks, their
    # classes are masked by the caller
    cs = g.lba // ts.FADAC_CHUNK_BLOCKS
    temps = ts.fadac_fold(torch.gather(st["sch_fadac_count"], 1, cs),
                          torch.gather(st["sch_fadac_last"], 1, cs), g.t[:, None])
    return ts.fadac_class(temps)


# -- warcip: online k-means over log rewrite intervals ---------------------------

def _warcip_spec(cfg):
    k = (len(ts.WARCIP_CENTROID_INIT),)
    return {"sch_warcip_last": ((cfg.n_lbas,), I32, -1),
            "sch_warcip_cent": (k, F32, ts.WARCIP_CENTROID_INIT),
            "sch_warcip_cnt": (k, F32, 1.0)}


def _warcip_user(cfg, st, w):
    last, cent, cnt = st["sch_warcip_last"], st["sch_warcip_cent"], st["sch_warcip_cnt"]
    flat = _flat(w, last)
    last_prev = last.view(-1)[flat]
    known = last_prev >= 0
    li = ts.warcip_interval(w.t - last_prev)
    j = ts.warcip_assign(cent, li)
    jl = j.long()
    new_c, new_n = ts.warcip_update(torch.gather(cent, 1, jl[:, None])[:, 0],
                                    torch.gather(cnt, 1, jl[:, None])[:, 0], li)
    at = w.k.kept(cent, w.k.base(cent.shape[1]) + jl, w.keep & known)
    put(cent, at, new_c)
    put(cnt, at, new_n)
    put(last, w.k.kept(last, flat, w.keep), w.t)
    return torch.where(known, j, 4).clamp(0, 5)


STATEFUL = {
    SCHEME_IDS["fk"]: Stateful(_fk_spec, _fk_user, _fk_gc),
    SCHEME_IDS["dac"]: Stateful(_dac_spec, _dac_user, _dac_gc),
    SCHEME_IDS["ml"]: Stateful(_ml_spec, _ml_user, _ml_gc),
    SCHEME_IDS["sfs"]: Stateful(_sfs_spec, _sfs_user, _sfs_gc),
    SCHEME_IDS["eti"]: Stateful(_eti_spec, _eti_user, 2),
    SCHEME_IDS["mq"]: Stateful(_mq_spec, _mq_user, 5),
    SCHEME_IDS["sfr"]: Stateful(_sfr_spec, _sfr_user, 5),
    SCHEME_IDS["fadac"]: Stateful(_fadac_spec, _fadac_user, _fadac_gc),
    SCHEME_IDS["warcip"]: Stateful(_warcip_spec, _warcip_user, 5),
}


def state_spec(cfg) -> dict:
    """Every stateful scheme's keys: per-volume shape, dtype and initial
    value, in the JAX state's order."""
    out = {}
    for sid in sorted(STATEFUL):
        out.update(STATEFUL[sid].spec(cfg))
    return out


def user_classes(cfg, st: dict, w: UserWrite, cls):
    """``cls`` (V,) with each stateful volume's class replaced by its
    scheme's; ``w.keep`` is the step's active mask (a 0-d True when every
    volume writes). Only the schemes present (``w.k.stateful``) run."""
    k = w.k
    with torch.profiler.record_function("stateful_schemes.user"):
        for sid in k.stateful:
            member = k.member[sid]
            mine = STATEFUL[sid].user(cfg, st, w._replace(keep=member & w.keep))
            cls = torch.where(member, mine, cls)
    return cls


def _gc_constant(k: Consts):
    """(V, 1) mask and class of the volumes whose scheme sends every GC
    rewrite to one class, made once per replay; None when there are none."""
    if not hasattr(k, "gc_constant"):
        const = [sid for sid in k.stateful if isinstance(STATEFUL[sid].gc, int)]
        if not const:
            k.gc_constant = None
        else:
            mask = torch.zeros_like(k.member[const[0]])
            value = torch.zeros(mask.shape, dtype=I32, device=mask.device)
            for sid in const:
                mask = mask | k.member[sid]
                value = torch.where(k.member[sid], STATEFUL[sid].gc, value)
            k.gc_constant = (mask[:, None], value[:, None])
    return k.gc_constant


def gc_classes(cfg, st: dict, g: GcVictims, cls):
    """``cls`` (V, s) with each stateful volume's GC classes replaced by its
    scheme's; ``g.keep`` is the tick's ``do`` (the victim is rewritten)."""
    k = g.k
    with torch.profiler.record_function("stateful_schemes.gc"):
        for sid in k.stateful:
            impl = STATEFUL[sid]
            if not isinstance(impl.gc, int):
                member = k.member[sid]
                mine = impl.gc(cfg, st, g._replace(keep=member & g.keep))
                cls = torch.where(member[:, None], mine, cls)
        const = _gc_constant(k)
        if const is not None:
            cls = torch.where(const[0], const[1], cls)
    return cls
