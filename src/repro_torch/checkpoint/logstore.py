"""Log-structured checkpoint blob store with SepBIT placement. The port's copy
of the JAX package's ``checkpoint/logstore.py`` (pure Python), held equal to
it, field for field, by the tests.

Checkpoints are the training-side log-structured workload: every save
appends shard blobs; the previous save's blobs for the same key become
garbage (kept only while referenced by a retained manifest); segment files
are compacted by GC. Optimizer-state blobs die every save; model-EMA /
dataset-state blobs live for many saves; retained "keep" checkpoints live
forever — exactly the BIT spread SepBIT separates.

Blobs are packed into fixed-size segment files on disk; the store tracks
per-blob last-write metadata (the paper's on-disk metadata) and places blobs
into class segments via Algorithm 1 with lifespans measured in bytes written.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os


@dataclasses.dataclass(frozen=True)
class LogStoreConfig:
    segment_bytes: int = 4 << 20
    gp_threshold: float = 0.15
    policy: str = "sepbit"              # sepbit | nosep
    nc_window: int = 8


@dataclasses.dataclass
class BlobMeta:
    key: str
    segment: int
    offset: int
    size: int
    utime: int          # bytes-written clock at last user write
    digest: str


class LogBlobStore:
    """Append-only blob store: put(key, bytes) supersedes the previous value
    of key; GC compacts segment files; WA is measured in bytes."""

    def __init__(self, root: str, cfg: LogStoreConfig = LogStoreConfig()):
        self.root = root
        self.cfg = cfg
        os.makedirs(root, exist_ok=True)
        self.t = 0                                  # bytes-written clock
        self.live: dict[str, BlobMeta] = {}
        self.seg_meta: dict[int, dict] = {}         # sid -> {cls, size, live, ctime, stime}
        self.open: dict[int, int] = {}              # cls -> sid
        self._next_sid = 0
        self.ell = float("inf")
        self._nc = 0
        self._ell_tot = 0.0
        self.user_bytes = 0
        self.gc_bytes = 0
        self._load_index()

    # -- segment files ----------------------------------------------------------
    def _seg_path(self, sid: int) -> str:
        return os.path.join(self.root, f"seg_{sid:08d}.log")

    def _index_path(self) -> str:
        return os.path.join(self.root, "index.json")

    def _new_segment(self, cls: int) -> int:
        sid = self._next_sid
        self._next_sid += 1
        self.seg_meta[sid] = {"cls": cls, "size": 0, "live": 0,
                              "ctime": self.t, "stime": -1}
        self.open[cls] = sid
        open(self._seg_path(sid), "wb").close()
        return sid

    def _class_for_put(self, key: str) -> int:
        if self.cfg.policy != "sepbit":
            return 0
        old = self.live.get(key)
        if old is None:
            return 1                                 # new write: Class 2
        v = self.t - old.utime
        return 0 if v < self.ell else 1

    def _class_for_gc(self, meta: BlobMeta, from_cls: int) -> int:
        if self.cfg.policy != "sepbit":
            return 0
        if from_cls == 0:
            return 2
        g = self.t - meta.utime
        if g < 4 * self.ell:
            return 3
        if g < 16 * self.ell:
            return 4
        return 5

    # -- API ----------------------------------------------------------------------
    def put(self, key: str, data: bytes) -> BlobMeta:
        old = self.live.get(key)
        if old is not None:
            sm = self.seg_meta.get(old.segment)
            if sm is not None:
                sm["live"] -= old.size
        cls = self._class_for_put(key)
        meta = self._append(cls, key, data, utime=self.t, from_gc=False)
        self.user_bytes += len(data)
        self.t += len(data)
        self.live[key] = meta
        self._maybe_gc()
        return meta

    def get(self, key: str) -> bytes:
        meta = self.live[key]
        with open(self._seg_path(meta.segment), "rb") as f:
            f.seek(meta.offset)
            data = f.read(meta.size)
        if hashlib.sha256(data).hexdigest() != meta.digest:
            raise IOError(f"checksum mismatch for {key}")
        return data

    def delete(self, key: str):
        old = self.live.pop(key, None)
        if old is not None:
            sm = self.seg_meta.get(old.segment)
            if sm is not None:
                sm["live"] -= old.size

    def keys(self):
        return list(self.live)

    def _append(self, cls: int, key: str, data: bytes, *, utime: int,
                from_gc: bool) -> BlobMeta:
        sid = self.open.get(cls)
        if sid is None or self.seg_meta[sid]["size"] + len(data) > self.cfg.segment_bytes:
            if sid is not None:
                self.seg_meta[sid]["stime"] = self.t   # seal
            sid = self._new_segment(cls)
        sm = self.seg_meta[sid]
        with open(self._seg_path(sid), "ab") as f:
            offset = f.tell()
            f.write(data)
        sm["size"] += len(data)
        sm["live"] += len(data)
        if from_gc:
            self.gc_bytes += len(data)
        return BlobMeta(key, sid, offset, len(data), utime,
                        hashlib.sha256(data).hexdigest())

    # -- GC --------------------------------------------------------------------------
    def _gp(self) -> float:
        total = sum(m["size"] for m in self.seg_meta.values())
        live = sum(max(m["live"], 0) for m in self.seg_meta.values())
        return 1.0 - live / total if total else 0.0

    def _maybe_gc(self):
        rounds = 0
        while self._gp() > self.cfg.gp_threshold and rounds < 64:
            rounds += 1
            sealed = [(sid, m) for sid, m in self.seg_meta.items()
                      if sid not in self.open.values() and m["size"] > 0]
            if not sealed:
                return
            def score(item):
                sid, m = item
                u = max(m["live"], 0) / max(m["size"], 1)
                age = max(self.t - (m["stime"] if m["stime"] >= 0 else m["ctime"]), 0)
                return (1 - u) * age / (1 + u)
            best = max(sealed, key=score)
            if best[1]["live"] >= best[1]["size"]:
                return
            self._collect(best[0])

    def _collect(self, sid: int):
        victims = [m for m in self.live.values() if m.segment == sid]
        from_cls = self.seg_meta[sid]["cls"]
        for meta in victims:
            with open(self._seg_path(sid), "rb") as f:
                f.seek(meta.offset)
                data = f.read(meta.size)
            cls = self._class_for_gc(meta, from_cls)
            newm = self._append(cls, meta.key, data, utime=meta.utime, from_gc=True)
            self.live[meta.key] = newm
        # ℓ monitor (Class-1 victims)
        if from_cls == 0:
            self._nc += 1
            self._ell_tot += self.t - self.seg_meta[sid]["ctime"]
            if self._nc >= self.cfg.nc_window:
                self.ell = self._ell_tot / self._nc
                self._nc = 0
                self._ell_tot = 0.0
        os.remove(self._seg_path(sid))
        del self.seg_meta[sid]
        self._save_index()

    # -- durability --------------------------------------------------------------------
    def _save_index(self):
        tmp = self._index_path() + ".tmp"
        payload = {
            "t": self.t, "next_sid": self._next_sid, "ell": self.ell,
            "user_bytes": self.user_bytes, "gc_bytes": self.gc_bytes,
            "live": {k: dataclasses.asdict(m) for k, m in self.live.items()},
            "seg_meta": self.seg_meta, "open": self.open,
        }
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._index_path())

    def _load_index(self):
        if not os.path.exists(self._index_path()):
            return
        with open(self._index_path()) as f:
            p = json.load(f)
        self.t = p["t"]
        self._next_sid = p["next_sid"]
        self.ell = p["ell"]
        self.user_bytes = p["user_bytes"]
        self.gc_bytes = p["gc_bytes"]
        self.live = {k: BlobMeta(**m) for k, m in p["live"].items()}
        self.seg_meta = {int(k): v for k, v in p["seg_meta"].items()}
        self.open = {int(k): v for k, v in p["open"].items()}

    def sync(self):
        self._save_index()

    @property
    def write_amplification(self) -> float:
        if self.user_bytes == 0:
            return 1.0
        return (self.user_bytes + self.gc_bytes) / self.user_bytes
