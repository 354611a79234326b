"""Plain NumPy reference of one log-structured volume under one of the
paper's 14 placement schemes.

It replays a block trace write by write, with the semantics of the port's
tick engine (the paper's Algorithm 1 and its GC loop), written here from
those semantics and independent of the port's code:

- a user write invalidates the LBA's previous block, takes its scheme's
  class (SepBIT: 0 when its lifespan estimate ``v = t - last_write(lba)``
  is below ℓ, else 1), is appended to its class's open segment, and a full
  segment is sealed and replaced by the lowest free segment;
- after each user write, while the garbage proportion exceeds the
  threshold (at most ``max_gc_per_step`` times), one GC operation takes the
  sealed segment of highest cost-benefit score ``((1 - u) * age) / (1 + u)``
  (ties to the lower row), updates ℓ from Class-1 victims (every
  ``nc_window`` of them, ℓ becomes their mean lifespan), and rewrites its
  live blocks into their scheme's GC classes (SepBIT: 2 from Class 1, else
  3-5 by age against 4ℓ and 16ℓ); each class appends to its open segment,
  then to the (c+1)-th lowest free segment, which opens when the first
  fills.

The stateful schemes keep their tables here (`Tables`) and follow the
formulas of the paper's baselines as the JAX package states them (its
``placement/temperature_shared.py`` for eti, mq, sfr, fadac and warcip).
Float arithmetic is float32, one rounding per operation, as the
configuration states; ``precision="bfloat16"`` rounds the victim scores,
ℓ, the garbage proportion and ℓ's comparisons to bfloat16 instead (the
control that a sound comparison has to fail). It imports nothing but NumPy.
"""

from __future__ import annotations

import math

import numpy as np

BIG = 2 ** 30            # "never written": last write time -BIG
NOBIT = 2 ** 30          # fk: "no next write"
EXACT = 2 ** 24          # integers below this are exact in float32
CLASSES = {"nosep": 1, "sepgc": 2, "sepbit": 6, "fk": 6, "dac": 6, "ml": 6, "sfs": 6,
           "uw": 3, "gw": 4, "eti": 3, "mq": 6, "sfr": 6, "fadac": 6, "warcip": 6}
COUNT_KEYS = ("user_writes", "gc_writes", "reclaimed", "overflow")
F32 = np.float32
LN2 = F32(0.6931471805599453)
ETI_EXTENT, ETI_EPOCH = 256, 1 << 15
SFR_CHUNK, SFR_NEVER = 64, -(2 ** 30)
FADAC_CHUNK, FADAC_HALF_LIFE = 64, 1 << 16
WARCIP_CENTROIDS, WARCIP_CAP = (2.0, 6.0, 10.0, 14.0, 18.0), F32(1024.0)
# sfs's quantile positions i / 6, each i * f32(1/6) rounded to float32
SFS_Q = [F32(i) * (F32(1.0) / F32(6.0)) for i in range(1, 6)]


def _bf16(x) -> np.float32:
    """Round a float32 value to bfloat16 (nearest, ties to even)."""
    b = np.array(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)[()] if b.ndim == 0 else b.view(np.float32)


def pool_rows(n_lbas: int, segment_size: int, gp_max: float, class_slots: int) -> int:
    """Segments of a volume's pool, sized from the largest GP threshold it
    may run (float32, read back as a Python float): twice the segments that
    hold the capacity at that threshold, plus four per class slot and 8."""
    cap = int(math.ceil(n_lbas / (1.0 - float(np.float32(gp_max))) / segment_size))
    return 2 * cap + 4 * class_slots + 8


def next_writes(trace) -> list:
    """fk's future knowledge: for each write, the index of the next write to
    its LBA, or NOBIT."""
    out, seen = [NOBIT] * len(trace), {}
    for i in range(len(trace) - 1, -1, -1):
        out[i] = seen.get(trace[i], NOBIT)
        seen[trace[i]] = i
    return out


def _ladder(x, thresholds) -> int:
    return sum(x >= th for th in thresholds)


def _log2_interp(x: int) -> np.float32:
    """Piecewise-linear log2 of an integer x >= 1: f + x / 2^f - 1, f =
    floor(log2 x), in float32."""
    f = max(x.bit_length() - 1, 0)
    return F32(F32(f) + F32(x) / F32(1 << f)) - F32(1.0)


class Tables:
    """A stateful scheme's tables and its classes (the paper's baselines).
    ``user(lba, t, nxt)`` classes a user write at time t (before it) and
    updates the tables; ``gc(lbas, t)`` classes a victim's live blocks."""

    def __init__(self, scheme: str, n_lbas: int, segment_size: int, sfs_resample: int):
        self.scheme, self.s, self.resample = scheme, segment_size, sfs_resample
        n = n_lbas
        if scheme == "fk":
            self.bit = [NOBIT] * n
        elif scheme == "dac":
            self.region = [0] * n
        elif scheme == "ml":
            self.count, self.level = [0] * n, [0] * n
        elif scheme == "sfs":
            self.count, self.first = np.zeros(n, np.int64), np.full(n, -1, np.int64)
            self.since, self.ready, self.bounds = 0, False, [F32(0.0)] * 5
        elif scheme == "eti":
            n_ext = -(-n // ETI_EXTENT)
            self.count, self.last = np.zeros(n_ext, np.int64), np.zeros(n_ext, np.int64)
        elif scheme == "mq":
            self.freq, self.level, self.expire = [0] * n, [0] * n, [0] * n
        elif scheme == "sfr":
            n_ch = -(-n // SFR_CHUNK)
            self.freq, self.last, self.prev = [F32(0.0)] * n_ch, [SFR_NEVER] * n_ch, -2
        elif scheme == "fadac":
            n_ch = -(-n // FADAC_CHUNK)
            self.count, self.last = [0] * n_ch, [0] * n_ch
        elif scheme == "warcip":
            self.last = [-1] * n
            self.cent = [F32(c) for c in WARCIP_CENTROIDS]
            self.cnt = [F32(1.0)] * len(WARCIP_CENTROIDS)
        else:
            raise ValueError(f"no tables for scheme {scheme!r}")

    # fk: the class of the remaining lifespan in segments, 5 for none
    def _fk(self, nxt: int, t: int) -> int:
        if nxt >= NOBIT:
            return 5
        return min(max((max(nxt - t, 1) + self.s - 1) // self.s - 1, 0), 5)

    # sfs: hotness count / age and quantile groups
    @staticmethod
    def _hot(count: int, first: int, t: int) -> np.float32:
        return F32(count) / F32(max(t - first, 1))

    def _sfs_class(self, h) -> int:
        if not self.ready:
            return 0
        b = self.bounds      # the binary search of searchsorted(side="left"), 3 halvings
        low, high = (0, 2) if h <= b[2] else (2, 5)
        for _ in range(2):
            mid = (low + high) // 2
            low, high = (low, mid) if h <= b[mid] else (mid, high)
        return min(max(5 - high, 0), 5)

    def _sfs_refresh(self, t: int) -> None:
        seen = self.first >= 0
        kk = int(seen.sum())
        if kk < 6:
            return
        age = np.maximum(t - self.first, 1).astype(np.float32)
        h = np.where(seen, self.count.astype(np.float32) / age, np.float32(np.inf))
        hs = np.sort(h.astype(np.float32))
        bounds = []
        for qf in SFS_Q:
            q = F32(qf * F32(kk - 1))
            lo, hi = math.floor(q), math.ceil(q)
            frac = F32(q - F32(lo))
            # hs[hi] * frac + hs[lo] * (1 - frac), the first product and the
            # sum rounded once (a fused multiply-add)
            c = F32(hs[lo] * F32(F32(1.0) - frac))
            bounds.append(F32(float(hs[hi]) * float(frac) + float(c)))
        self.bounds, self.ready = bounds, True

    def _eti_class(self, e: int, epoch: int) -> int:
        temps = self.count >> np.clip(epoch - self.last, 0, 31)
        thr = max(F32(F32(int(temps.sum())) / F32(len(temps))), F32(1.0))
        return 0 if F32(int(temps[e])) > thr else 1

    def _fadac_temp(self, c: int, t: int) -> int:
        return self.count[c] >> min(max(t - self.last[c], 0) // FADAC_HALF_LIFE, 31)

    def user(self, lba: int, t: int, nxt: int) -> int:
        sc = self.scheme
        if sc == "fk":
            self.bit[lba] = nxt
            return self._fk(nxt, t)
        if sc == "dac":
            r = min(max(self.region[lba] + 1, 1), 5)
            self.region[lba] = r
            return 5 - r
        if sc == "ml":
            c = self.count[lba] + 1
            lvl = _ladder(c, (2, 4, 8, 16, 32))
            self.count[lba], self.level[lba] = c, lvl
            return 5 - lvl
        if sc == "sfs":
            f1 = t if self.first[lba] < 0 else int(self.first[lba])
            c1 = int(self.count[lba]) + 1
            self.first[lba], self.count[lba] = f1, c1
            self.since += 1
            if self.since >= self.resample:
                self._sfs_refresh(t)
                self.since = 0
            return self._sfs_class(self._hot(c1, f1, t))
        if sc == "eti":
            e = lba // ETI_EXTENT
            before = t // ETI_EPOCH
            self.count[e] = (int(self.count[e]) >> min(max(before - int(self.last[e]), 0), 31)) + 1
            self.last[e] = before
            return self._eti_class(e, (t + 1) // ETI_EPOCH)
        if sc == "mq":
            f = self.freq[lba] + 1
            prev = self.level[lba]
            demote = 1 if t > self.expire[lba] and prev > 0 else 0
            lvl = max(_ladder(f, (2, 4, 8, 16)), prev - demote)
            self.freq[lba], self.level[lba], self.expire[lba] = f, lvl, t + 4 * self.s
            return min(max(4 - lvl, 0), 5)
        if sc == "sfr":
            c = lba // SFR_CHUNK
            seq = F32(1.0) if lba == self.prev + 1 else F32(0.0)
            dt = max(t - self.last[c], 0)
            f_new = F32(F32(F32(0.9) * self.freq[c]) + F32(1.0))
            self.freq[c], self.last[c], self.prev = f_new, t, lba
            ln = F32(LN2 * _log2_interp(dt + 1))
            rec = F32(F32(1.0) / F32(F32(1.0) + ln))
            fnorm = min(F32(f_new / F32(16.0)), F32(1.0))
            score = F32(F32(F32(F32(0.4) * fnorm) + F32(F32(0.4) * rec))
                        + F32(F32(0.2) * F32(F32(1.0) - seq)))
            lvl = int(min(max(F32(score * F32(5.0)), F32(0.0)), F32(4.0)))
            return min(max(4 - lvl, 0), 5)
        if sc == "fadac":
            c = lba // FADAC_CHUNK
            cnt = self._fadac_temp(c, t) + 1
            self.count[c], self.last[c] = cnt, t
            return min(max(5 - _ladder(cnt, (1, 3, 7, 15, 31)), 0), 5)
        # warcip: online k-means over log rewrite intervals
        prev = self.last[lba]
        self.last[lba] = t
        if prev < 0:
            return 4
        li = _log2_interp(max(t - prev, 1) + 1)
        dist = [abs(F32(c - li)) for c in self.cent]
        j = dist.index(min(dist))
        c2 = F32(self.cnt[j] + F32(1.0))
        self.cent[j] = F32(self.cent[j] + F32(F32(li - self.cent[j]) / min(c2, WARCIP_CAP)))
        self.cnt[j] = c2
        return j

    def gc(self, lbas: list, t: int) -> list:
        sc = self.scheme
        if sc in ("mq", "sfr", "warcip"):
            return [5] * len(lbas)
        if sc == "eti":
            return [2] * len(lbas)
        if sc == "fk":
            return [self._fk(self.bit[b], t) for b in lbas]
        if sc == "sfs":
            return [self._sfs_class(self._hot(int(self.count[b]), int(self.first[b]), t))
                    for b in lbas]
        if sc == "fadac":
            return [min(max(5 - _ladder(self._fadac_temp(b // FADAC_CHUNK, t),
                                        (1, 3, 7, 15, 31)), 0), 5) for b in lbas]
        out = []
        for b in lbas:          # dac, ml: one step down on every rewrite
            if sc == "dac":
                r = min(max(self.region[b] - 1, 0), 5)
                self.region[b] = r
            else:
                r = min(max(self.level[b] - 1, 0), 5)
                self.level[b] = r
            out.append(5 - r)
        return out


class Volume:
    """One volume's state and its replay under ``scheme``. ``precision``:
    ``"float32"``, or ``"bfloat16"`` for the control."""

    def __init__(self, n_lbas: int, segment_size: int, gp_threshold: float, n_segments: int,
                 *, scheme: str = "sepbit", nc_window: int = 16, max_gc_per_step: int = 64,
                 class_slots: int = 6, sfs_resample: int = 4096, precision: str = "float32"):
        if scheme not in CLASSES or CLASSES[scheme] > class_slots:
            raise ValueError(f"unknown scheme {scheme!r}, or more classes than slots")
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.r = np.float32 if precision == "float32" else _bf16
        self.exact = precision == "float32"
        self.scheme = scheme
        self.tables = (None if scheme in ("nosep", "sepgc", "sepbit", "uw", "gw")
                       else Tables(scheme, n_lbas, segment_size, sfs_resample))
        s, R, C = segment_size, n_segments, class_slots
        self.s, self.R, self.C = s, R, C
        self.gp = self.r(gp_threshold)
        self.ncw, self.max_gc = nc_window, max_gc_per_step
        self.loc_seg = [-1] * n_lbas
        self.loc_off = [0] * n_lbas
        self.last_uw = [-BIG] * n_lbas
        self.seg_lba = np.zeros((R, s), np.int32)
        self.seg_utime = np.zeros((R, s), np.int32)
        self.seg_valid = np.zeros((R, s), bool)
        self.seg_n = np.zeros(R, np.int64)
        self.seg_nvalid = np.zeros(R, np.int64)
        self.seg_cls = np.zeros(R, np.int64)
        self.seg_state = np.zeros(R, np.int8)    # 0 free, 1 open, 2 sealed
        self.seg_ctime = np.zeros(R, np.int64)
        self.seg_stime = np.zeros(R, np.int64)
        # row c open for each of the scheme's classes c, created at time 0
        k = CLASSES[scheme]
        self.open_row = list(range(C))
        self.seg_state[:k] = 1
        self.seg_cls[:k] = np.arange(k)
        self.t = 0
        self.total_occ = 0
        self.total_valid = 0
        self.ell = np.float32(np.inf)
        self.ell_tot = np.float32(0.0)
        self.nc = 0
        self.user_writes = self.gc_writes = self.reclaimed = self.overflow = 0
        self.class_user = [0] * C
        self.class_gc = [0] * C

    # -- helpers ---------------------------------------------------------------

    def _free_rows(self, count: int) -> list:
        """The ``count`` lowest free rows (fewer where the pool runs out)."""
        return np.flatnonzero(self.seg_state == 0)[:count].tolist()

    def _over_threshold(self) -> bool:
        occ = max(self.total_occ, 1)
        if self.exact:
            exact = 1.0 - self.total_valid / occ
            if abs(exact - float(self.gp)) > 1e-6:
                return exact > float(self.gp)
        r = self.r
        return bool(r(r(1.0) - r(r(self.total_valid) / r(occ))) > self.gp)

    def _below_ell(self, v: int) -> bool:
        """float32(v) < ℓ (bfloat16(v) for the control)."""
        if self.exact and (v < EXACT or not self.ell < EXACT):
            # v < ℓ for an exact v; for a large v (a fresh LBA) with a finite
            # ℓ below 2^24 it is false, as rounding keeps v at or above 2^24
            return v < self.ell
        return self.r(v) < self.ell

    def _user_class(self, lba: int, t: int, nxt: int) -> int:
        sc = self.scheme
        if self.tables is not None:
            return self.tables.user(lba, t, nxt)
        if sc in ("sepbit", "uw"):
            return 0 if self._below_ell(t - self.last_uw[lba]) else 1
        return 0             # nosep, sepgc, gw: one user class

    def _gc_classes(self, lbas, utimes, t: int, from_c1: bool) -> np.ndarray:
        sc = self.scheme
        if self.tables is not None:
            return np.asarray(self.tables.gc(lbas.tolist(), t), np.int64)
        if sc in ("nosep", "sepgc", "uw"):
            return np.full(len(lbas), {"nosep": 0, "sepgc": 1, "uw": 2}[sc])
        if sc == "sepbit" and from_c1:
            return np.full(len(lbas), 2)
        # by age g = t - write time against 4ℓ and 16ℓ: sepbit 3-5, gw 1-3
        r = self.r
        g = (t - utimes).astype(np.float32)
        if not self.exact:
            g = r(g)
        older = ((g >= r(np.float32(4.0) * self.ell)).astype(np.int64)
                 + (g >= r(np.float32(16.0) * self.ell)).astype(np.int64))
        return (3 if sc == "sepbit" else 1) + older

    def _victim(self) -> int:
        """The sealed row of highest cost-benefit score, ties to the lower
        row; -1 when none holds garbage."""
        r = self.r
        sealed = np.flatnonzero((self.seg_state == 2) & (self.seg_n > self.seg_nvalid))
        if sealed.size == 0:
            return -1
        nf = self.seg_n[sealed].astype(np.float32)
        nvf = self.seg_nvalid[sealed].astype(np.float32)
        u = r(nvf / np.maximum(nf, np.float32(1.0)))
        age = r(np.maximum(self.t - self.seg_stime[sealed], 0).astype(np.float32))
        score = r(r(r(np.float32(1.0) - u) * age) / r(np.float32(1.0) + u))
        return int(sealed[int(np.argmax(score))])

    def _open(self, row: int, cls: int, t: int) -> None:
        self.seg_state[row] = 1
        self.seg_cls[row] = cls
        self.seg_ctime[row] = t

    # -- the replay ------------------------------------------------------------

    def write(self, lba: int, nxt: int = NOBIT) -> None:
        """One user write (``nxt``: the index of the next write to its LBA,
        fk's future knowledge), then the GC loop."""
        t, s = self.t, self.s
        old = self.loc_seg[lba]
        if old >= 0:
            self.seg_valid[old, self.loc_off[lba]] = False
            self.seg_nvalid[old] -= 1
        else:
            self.total_valid += 1
        cls = self._user_class(lba, t, nxt)
        row = self.open_row[cls]
        off = int(self.seg_n[row])
        self.seg_lba[row, off] = lba
        self.seg_utime[row, off] = t
        self.seg_valid[row, off] = True
        self.seg_n[row] = off + 1
        self.seg_nvalid[row] += 1
        self.loc_seg[lba] = row
        self.loc_off[lba] = off
        self.last_uw[lba] = t
        if off + 1 >= s:
            fresh = self._free_rows(1)
            if not fresh:
                raise OverflowError("segment pool exhausted")
            self.seg_state[row] = 2
            self.seg_stime[row] = t
            self._open(fresh[0], cls, t)
            self.open_row[cls] = fresh[0]
        self.t = t + 1
        self.total_occ += 1
        self.user_writes += 1
        self.class_user[cls] += 1
        for _ in range(self.max_gc):
            if not self._over_threshold():
                break
            victim = self._victim()
            if victim < 0:
                break
            self._collect(victim)

    def _collect(self, victim: int) -> None:
        """One GC operation on ``victim``: ℓ, the live blocks' classes, their
        rewrite, the victim's release."""
        r, s, t = self.r, self.s, self.t
        from_c1 = bool(self.seg_cls[victim] == 0)
        if from_c1:
            self.nc += 1
            self.ell_tot = r(self.ell_tot + r(t - int(self.seg_ctime[victim])))
        if self.nc >= self.ncw:
            self.ell = r(self.ell_tot / r(self.nc))
            self.nc = 0
            self.ell_tot = np.float32(0.0)
        live = np.flatnonzero(self.seg_valid[victim])
        lbas = self.seg_lba[victim, live]
        utimes = self.seg_utime[victim, live]
        classes = self._gc_classes(lbas, utimes, t, from_c1)
        fresh = self._free_rows(self.C)
        for c in np.unique(classes).tolist():
            sel = classes == c
            count = int(sel.sum())
            row = self.open_row[c]
            n0 = int(self.seg_n[row])
            took1 = min(count, s - n0)
            dst_row = np.full(count, row)
            dst_off = n0 + np.arange(count)
            if took1 < count or n0 + took1 >= s:
                if len(fresh) <= c:
                    raise OverflowError("segment pool exhausted")
                f = fresh[c]
                dst_row[took1:] = f
                dst_off[took1:] -= s
            self.seg_lba[dst_row, dst_off] = lbas[sel]
            self.seg_utime[dst_row, dst_off] = utimes[sel]
            self.seg_valid[dst_row, dst_off] = True
            for lba, dr, do in zip(lbas[sel].tolist(), dst_row.tolist(), dst_off.tolist()):
                self.loc_seg[lba] = dr
                self.loc_off[lba] = do
            self.seg_n[row] += took1
            self.seg_nvalid[row] += took1
            if n0 == 0:
                self.seg_ctime[row] = t
            if n0 + took1 >= s:
                self.seg_n[f] += count - took1
                self.seg_nvalid[f] += count - took1
                self.seg_state[row] = 2
                self.seg_stime[row] = t
                self._open(f, c, t)
                self.open_row[c] = f
            self.class_gc[c] += count
        self.seg_state[victim] = 0
        self.seg_valid[victim] = False
        self.total_occ += live.size - int(self.seg_n[victim])
        self.seg_n[victim] = 0
        self.seg_nvalid[victim] = 0
        self.gc_writes += live.size
        self.reclaimed += 1

    def summary(self) -> dict:
        out = {key: getattr(self, key) for key in COUNT_KEYS}
        out["class_user_writes"] = list(self.class_user)
        out["class_gc_writes"] = list(self.class_gc)
        out["ell"] = float(self.ell)
        return out


def replay(trace, *, n_lbas: int, segment_size: int, gp_threshold: float, n_segments: int,
           scheme: str = "sepbit", nc_window: int = 16, max_gc_per_step: int = 64,
           class_slots: int = 6, sfs_resample: int = 4096, precision: str = "float32") -> dict:
    """Replay one volume's trace (1-D LBAs; -1 entries, a padded tail, are
    skipped) and return its counts: user and GC writes, reclaimed segments,
    allocations that found the pool exhausted (the replay stops at the
    first), per-class user and GC writes, and ℓ."""
    vol = Volume(n_lbas, segment_size, gp_threshold, n_segments, scheme=scheme,
                 nc_window=nc_window, max_gc_per_step=max_gc_per_step, class_slots=class_slots,
                 sfs_resample=sfs_resample, precision=precision)
    lbas = np.asarray(trace)
    lbas = lbas[lbas >= 0].tolist()
    if lbas and (max(lbas) >= n_lbas or len(lbas) >= EXACT):
        raise ValueError("LBAs must lie in [0, n_lbas), and a trace hold under 2^24 writes")
    nxt = next_writes(lbas) if scheme == "fk" else [NOBIT] * len(lbas)
    try:
        for lba, n in zip(lbas, nxt):
            vol.write(lba, n)
    except OverflowError:
        vol.overflow += 1
    return vol.summary()
