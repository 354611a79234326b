"""SepBIT-managed log-structured KV page store (the paper's technique as a
first-class serving feature). The port's copy of the JAX package's
``serving/logkv.py``: pure Python, held equal to it by the tests.

A paged KV cache is log-structured storage: KV pages are appended while a
sequence decodes (user writes), invalidated when the sequence finishes, and
compaction (GC) copies live pages out of fragmented *frames* (segments) to
reclaim contiguous space. Copy traffic is exactly the paper's write
amplification, and it steals HBM bandwidth from decode — minimizing it is
minimizing the collective+memory roofline term of serving.

SepBIT's mechanism transfers directly:
  - A page's BIT is its sequence's finish time. The predecessor-lifespan
    signal maps to *sequence age*: with skewed length distributions (real
    serving traffic), a page of a young sequence likely dies soon, exactly
    the paper's Pr(u <= u0 | v <= v0) claim with lifespans measured in
    decoded tokens (§3.2 math applies verbatim).
  - ℓ is the windowed mean lifetime of recently *finished* sequences
    (Algorithm 1's monitor over reclaimed Class-1 segments).
  - Fresh pages of sequences younger than ℓ go to Class 1, older to Class 2;
    compaction-copied pages split into Classes 3-6 by page age
    ([0,4ℓ), [4ℓ,16ℓ), [16ℓ,∞)) — Algorithm 1's GCWrite verbatim.

The store manages page *indices*; tensor movement is delegated to the paged
attention layer (one gather per copied page, accounted as WA here).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LogKVConfig:
    # design floor: n_frames >= ~3x the policy's class count (the paper's
    # volumes have segments >> classes); below that, open frames pin the
    # whole pool and GC cannot consolidate.
    n_frames: int = 64                  # physical frames (segments)
    pages_per_frame: int = 64           # frame size s, in pages
    gp_threshold: float = 0.15          # GC trigger (paper §2.1)
    selector: str = "cost_benefit"      # greedy | cost_benefit
    policy: str = "sepbit"              # sepbit | sepgc | nosep
    nc_window: int = 16                 # ℓ averaging window (Algorithm 1)


@dataclasses.dataclass
class Page:
    seq_id: int
    born: int          # global decode-tick when written
    seq_age_at_write: int


class Frame:
    __slots__ = ("fid", "cls", "pages", "creation_time", "seal_time", "sealed",
                 "n_live")

    def __init__(self, fid, cls, t):
        self.fid = fid
        self.cls = cls
        self.pages: list[Page | None] = []
        self.creation_time = t
        self.seal_time = -1
        self.sealed = False
        self.n_live = 0


class LogKVStore:
    N_CLASSES = {"sepbit": 6, "sepgc": 2, "nosep": 1}

    def __init__(self, cfg: LogKVConfig):
        self.cfg = cfg
        self.t = 0                       # user-page-write clock
        self.n_classes = self.N_CLASSES[cfg.policy]
        self.frames: dict[int, Frame] = {}
        self.free: list[int] = list(range(cfg.n_frames))
        self.open: list[Frame | None] = [None] * self.n_classes
        self.seq_pages: dict[int, list[tuple[int, int]]] = {}  # seq -> [(fid, slot)]
        self.seq_age: dict[int, int] = {}
        # SepBIT state (Algorithm 1)
        self.ell = float("inf")
        self._ell_tot = 0.0
        self._nc = 0
        self._occupied = 0
        self._live = 0
        # stats
        self.user_writes = 0
        self.gc_writes = 0
        self.frames_reclaimed = 0
        self.alloc_failures = 0

    # -- frame lifecycle -------------------------------------------------------
    def _open_frame(self, cls: int) -> Frame | None:
        if self.open[cls] is not None and not self.open[cls].sealed:
            return self.open[cls]
        if not self.free:
            return None
        fid = self.free.pop()
        fr = Frame(fid, cls, self.t)
        self.frames[fid] = fr
        self.open[cls] = fr
        return fr

    def _seal_if_full(self, fr: Frame):
        if len(fr.pages) >= self.cfg.pages_per_frame:
            fr.sealed = True
            fr.seal_time = self.t
            if self.open[fr.cls] is fr:
                self.open[fr.cls] = None

    # -- SepBIT classification (Algorithm 1) -------------------------------------
    def _user_class(self, seq_id: int) -> int:
        if self.cfg.policy != "sepbit":
            return 0
        age = self.seq_age.get(seq_id, 0)
        return 0 if age < self.ell else 1

    def _gc_class(self, page: Page, from_cls: int) -> int:
        if self.cfg.policy == "nosep":
            return 0
        if self.cfg.policy == "sepgc":
            return 1
        if from_cls == 0:
            return 2
        g = self.t - page.born
        if g < 4 * self.ell:
            return 3
        if g < 16 * self.ell:
            return 4
        return 5

    # -- API ---------------------------------------------------------------------
    def append_page(self, seq_id: int) -> tuple[int, int] | None:
        """A sequence decodes past a page boundary: allocate its next page.
        Returns (frame, slot) or None (pool exhausted after GC attempts)."""
        self._maybe_gc()
        cls = self._user_class(seq_id)
        fr = self._open_frame(cls)
        if fr is None:
            self._maybe_gc(force=True)
            fr = self._open_frame(cls)
            if fr is None:
                self.alloc_failures += 1
                return None
        slot = len(fr.pages)
        fr.pages.append(Page(seq_id, self.t, self.seq_age.get(seq_id, 0)))
        fr.n_live += 1
        self._occupied += 1
        self._live += 1
        self.seq_pages.setdefault(seq_id, []).append((fr.fid, slot))
        self.seq_age[seq_id] = self.seq_age.get(seq_id, 0) + 1
        self.user_writes += 1
        self.t += 1
        self._seal_if_full(fr)
        return fr.fid, slot

    def finish_sequence(self, seq_id: int):
        """Sequence completed: all its pages become garbage; feed ℓ monitor."""
        for fid, slot in self.seq_pages.pop(seq_id, []):
            fr = self.frames.get(fid)
            if fr is not None and slot < len(fr.pages) and fr.pages[slot] is not None:
                fr.pages[slot] = None
                fr.n_live -= 1
                self._live -= 1
        # lifetime sample = total decoded pages of this sequence
        life = self.seq_age.pop(seq_id, 0)
        self._nc += 1
        self._ell_tot += life
        if self._nc >= self.cfg.nc_window:
            self.ell = self._ell_tot / self._nc
            self._nc = 0
            self._ell_tot = 0.0

    def release_sequence(self, seq_id: int):
        """Preemption: free the sequence's pages without feeding the ℓ
        monitor (it did not complete; its lifetime sample would be biased)."""
        for fid, slot in self.seq_pages.pop(seq_id, []):
            fr = self.frames.get(fid)
            if fr is not None and slot < len(fr.pages) and fr.pages[slot] is not None:
                fr.pages[slot] = None
                fr.n_live -= 1
                self._live -= 1
        self.seq_age.pop(seq_id, None)

    # -- GC ------------------------------------------------------------------------
    def _gp(self) -> float:
        return 1.0 - self._live / self._occupied if self._occupied else 0.0

    def _scores(self):
        out = []
        for fr in self.frames.values():
            if not fr.sealed:
                continue
            n = len(fr.pages)
            garbage = n - fr.n_live
            if garbage == 0 and fr.n_live > 0:
                continue
            if self.cfg.selector == "greedy":
                score = garbage / max(n, 1)
            else:
                u = fr.n_live / max(n, 1)
                age = max(self.t - fr.seal_time, 0)
                score = (1 - u) * age / (1 + u)
            out.append((score, garbage, fr.fid))
        return out

    def _maybe_gc(self, force: bool = False):
        rounds = 0
        while (self._gp() > self.cfg.gp_threshold or (force and not self.free)) \
                and rounds < 2 * self.cfg.n_frames:
            rounds += 1
            scores = self._scores()
            if not scores:
                return
            _, garbage, fid = max(scores)
            if garbage == 0 and not force and self.free:
                # remaining garbage sits in open frames; collecting an
                # all-live frame is pure consolidation — only worth it when
                # the free list is empty (frame starvation)
                return
            if not self._collect(fid):
                return
            force = False

    def _collect(self, fid: int) -> bool:
        """Reclaim frame ``fid``: read its live pages to a staging buffer,
        free the frame, then re-append (the freed frame itself is reusable —
        real log-structured GC semantics, avoids relocation starvation)."""
        fr = self.frames[fid]
        moves = [(slot, p) for slot, p in enumerate(fr.pages) if p is not None]
        # capacity pre-check: open-slot space elsewhere + the freed frame
        pp = self.cfg.pages_per_frame
        free_slots = (len(self.free) + 1) * pp
        for f2 in self.frames.values():
            if not f2.sealed and f2.fid != fid:
                free_slots += pp - len(f2.pages)
        if free_slots < len(moves):
            return False
        del self.frames[fid]
        if self.open[fr.cls] is fr:
            self.open[fr.cls] = None
        self._occupied -= len(fr.pages)
        self._live -= fr.n_live
        self.free.append(fid)
        relocated: dict = {}
        for slot, page in moves:
            cls = self._gc_class(page, fr.cls)
            dest = self._open_frame(cls)
            if dest is None:  # degrade placement rather than fail
                dest = next((f2 for f2 in self.frames.values()
                             if not f2.sealed and len(f2.pages) < pp), None)
            assert dest is not None  # guaranteed by the pre-check
            s2 = len(dest.pages)
            dest.pages.append(page)
            dest.n_live += 1
            self._occupied += 1
            self._live += 1
            self.gc_writes += 1
            relocated[(fid, slot)] = (dest.fid, s2)
            self._seal_if_full(dest)
        if relocated:
            for table in self.seq_pages.values():
                for i, loc in enumerate(table):
                    if loc in relocated:
                        table[i] = relocated[loc]
        self.frames_reclaimed += 1
        return True

    # -- stats -----------------------------------------------------------------------
    @property
    def write_amplification(self) -> float:
        if self.user_writes == 0:
            return 1.0
        return (self.user_writes + self.gc_writes) / self.user_writes

    def stats(self) -> dict:
        return {
            "policy": self.cfg.policy,
            "wa": self.write_amplification,
            "user_writes": self.user_writes,
            "gc_writes": self.gc_writes,
            "frames_reclaimed": self.frames_reclaimed,
            "alloc_failures": self.alloc_failures,
            "ell": self.ell,
            "gp": self._gp(),
        }
