"""Fault-tolerant checkpointing on the SepBIT log-structured blob store, the
twin of the JAX package's ``checkpoint/ckpt.py`` over the port's trees.

- Keys and blobs are the reference's, so that each package restores the
  other's checkpoints: a leaf's key is its ``jax.tree_util.keystr`` path
  (``['params']['blocks']['p0_attn']['attn']['wq']``), taken in the
  reference's flattening order (dict keys sorted, list entries by index),
  which is also the order of the puts and so decides the store's segment
  packing; a blob is ``np.save`` bytes (``allow_pickle=False``), a bfloat16
  leaf under the header JAX's arrays give it (``'<V2'``) with ``"dtype":
  "bfloat16"`` in the manifest.
- Manifests are atomic (the store's index is written to a temporary file,
  fsynced and renamed) and hash-chained, so a crash mid-save leaves the
  previous checkpoint fully restorable.
- ``save`` snapshots every leaf to the host synchronously (a copy), so the
  step can proceed, and serializes on a background thread with
  ``async_save=True``.
- ``restore`` validates every blob checksum, the shapes and the manifest
  chain, and reads each blob through the manifest's dtype.
- Retention: keep the last ``keep`` checkpoints; superseded blobs become
  garbage for the store's GC. Optimizer moments churn every save while
  retained blobs live long: the BIT spread the SepBIT store separates.
"""

from __future__ import annotations

import hashlib
import io
import json
import threading
import time

import numpy as np
import torch

from .logstore import LogBlobStore, LogStoreConfig

_BF16_DESCR = "<V2"          # the header numpy writes for JAX's bfloat16 arrays


def _flatten(tree, prefix: str = "") -> list:
    """(keystr path, leaf) of every leaf, in the reference's order: dict keys
    sorted, list and tuple entries by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree_like, leaves):
    """``tree_like``'s nesting with its leaves replaced, in `_flatten`'s
    order, by the next of ``leaves`` (an iterator)."""
    if isinstance(tree_like, dict):
        out = {k: _unflatten(tree_like[k], leaves) for k in sorted(tree_like)}
        return {k: out[k] for k in tree_like}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, leaves) for v in tree_like)
    return next(leaves)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _ser(t: torch.Tensor) -> bytes:
    """A host tensor as the bytes ``np.save`` writes for the reference's
    array of the same values: its version 1.0 header, then the data in C
    order, joined in one copy."""
    if t.dtype == torch.bfloat16:
        arr, descr = t.contiguous().view(torch.int16).numpy(), _BF16_DESCR
    else:
        arr = t.contiguous().numpy()
        descr = np.lib.format.dtype_to_descr(arr.dtype)
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, {"descr": descr, "fortran_order": False, "shape": tuple(t.shape)})
    return b"".join((head.getvalue(), arr.reshape(-1).view(np.uint8)))


def _deser(data: bytes, dtype: str) -> torch.Tensor:
    """A blob as a host tensor of the manifest's ``dtype``."""
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 blob holds {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"a blob of dtype {arr.dtype} under the manifest's {dtype}")
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 2,
                 store_cfg: LogStoreConfig = LogStoreConfig()):
        self.store = LogBlobStore(root, store_cfg)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None

    # -- manifests ---------------------------------------------------------------
    def _manifest_key(self, step: int) -> str:
        return f"manifest/{step:012d}"

    def manifests(self) -> list[int]:
        return sorted(int(k.split("/")[1]) for k in self.store.keys()
                      if k.startswith("manifest/"))

    def latest_step(self) -> int | None:
        ms = self.manifests()
        return ms[-1] if ms else None

    # -- save ----------------------------------------------------------------------
    def save(self, step: int, tree, *, async_save: bool = False, meta: dict | None = None):
        """Checkpoint ``tree`` (nested dicts and lists of tensors) at ``step``.
        Blocks only for the host snapshot when async_save=True: a copy of
        every leaf, also of one already on the CPU, which the next step
        updates in place."""
        host = [(key, leaf.detach().to("cpu", copy=True)) for key, leaf in _flatten(tree)]
        if async_save:
            self.wait()
            th = threading.Thread(target=self._write, args=(step, host, meta))
            th.start()
            self._pending = th
        else:
            self._write(step, host, meta)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host, meta):
        with self._lock:
            prev = self.latest_step()
            prev_digest = ""
            if prev is not None:
                prev_digest = hashlib.sha256(
                    self.store.get(self._manifest_key(prev))).hexdigest()
            entries = {}
            for key, t in host:
                blob_key = f"blob/{step:012d}{key}"
                m = self.store.put(blob_key, _ser(t))
                entries[key] = {"blob": blob_key, "digest": m.digest,
                                "shape": list(t.shape), "dtype": _dtype_name(t)}
            manifest = {"step": step, "time": time.time(), "entries": entries,
                        "prev": prev, "prev_digest": prev_digest,
                        "meta": meta or {}}
            self.store.put(self._manifest_key(step),
                           json.dumps(manifest, sort_keys=True).encode())
            self._gc_old()
            self.store.sync()

    def _gc_old(self):
        steps = self.manifests()
        for old in steps[:-self.keep] if self.keep else []:
            manifest = json.loads(self.store.get(self._manifest_key(old)))
            for e in manifest["entries"].values():
                self.store.delete(e["blob"])
            self.store.delete(self._manifest_key(old))

    # -- restore ----------------------------------------------------------------------
    def restore(self, tree_like, step: int | None = None):
        """Restore into the structure of ``tree_like`` (validates shapes,
        checksums, and the manifest hash chain): each leaf a tensor of the
        manifest's dtype on the device of ``tree_like``'s leaf."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        manifest = json.loads(self.store.get(self._manifest_key(step)))
        if manifest["prev"] is not None:
            prev_key = self._manifest_key(manifest["prev"])
            if prev_key in self.store.live:
                got = hashlib.sha256(self.store.get(prev_key)).hexdigest()
                if got != manifest["prev_digest"]:
                    raise IOError("manifest hash chain broken")
        leaves = []
        for key, like in _flatten(tree_like):
            e = manifest["entries"][key]
            t = _deser(self.store.get(e["blob"]), e["dtype"])
            if list(t.shape) != list(like.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(t.shape)} vs {tuple(like.shape)}")
            leaves.append(t.to(like.device))
        return _unflatten(tree_like, iter(leaves)), manifest
