"""Block invalidation time (BIT) annotations for the future-knowledge scheme.

FK classifies each user write by the index of the next write to the same
LBA. These annotations are made on the host in numpy, once per replay, like
the traces themselves, and travel beside the trace as a (V, T) int32
``nxt`` stream. Copies of the JAX package's ``simulator.annotate_next_write``
and ``jaxsim.fk_annotations`` / ``fleet_annotations`` /
``coerce_fleet_annotations``; ``tests/test_torch_schemes.py`` holds them
equal.
"""

from __future__ import annotations

import numpy as np
import torch

from .placement.schemes import NOBIT, SCHEME_REQUIRES_FUTURE

INF = np.iinfo(np.int64).max // 4  # stand-in for an infinite lifespan or timestamp


def annotate_next_write(trace: np.ndarray, n_lbas: int = 0) -> np.ndarray:
    """For each request i, the index of the next write to the same LBA (INF
    if none). A stable sort by LBA lines up each LBA's writes in time order,
    so every request's successor is the next entry of its group. ``n_lbas``
    is unused (kept for the original's signature)."""
    trace = np.asarray(trace)
    m = len(trace)
    nxt = np.full(m, INF, dtype=np.int64)
    if m == 0:
        return nxt
    order = np.argsort(trace, kind="stable")
    sorted_lba = trace[order]
    same = sorted_lba[:-1] == sorted_lba[1:]
    nxt[order[:-1][same]] = order[1:][same]
    return nxt


def fk_annotations(trace) -> np.ndarray:
    """int32 index of each request's next write to its LBA, clipped to the
    ``NOBIT`` sentinel where there is none."""
    nxt = annotate_next_write(np.asarray(trace, dtype=np.int64))
    return np.minimum(nxt, NOBIT).astype(np.int32)


def fleet_annotations(padded: np.ndarray, scheme_ids) -> np.ndarray | None:
    """(V, T) annotations of a padded fleet: rows whose scheme needs future
    knowledge are annotated (their -1 pad entries link only to each other,
    and pad steps are no-ops), every other row is ``NOBIT``. None when no
    volume needs them."""
    need = [bool(SCHEME_REQUIRES_FUTURE[int(sid)]) for sid in np.asarray(scheme_ids)]
    if not any(need):
        return None
    out = np.full(padded.shape, NOBIT, dtype=np.int32)
    for i, row_needs in enumerate(need):
        if row_needs:
            out[i] = fk_annotations(padded[i])
    return out


def coerce_fleet_annotations(nxts, shape, device) -> torch.Tensor:
    """The annotation stream as a (V, T) int32 tensor on ``device``; a
    ``NOBIT`` fill for None."""
    if nxts is None:
        return torch.full(shape, NOBIT, dtype=torch.int32, device=device)
    if isinstance(nxts, torch.Tensor):
        out = nxts.to(device=device, dtype=torch.int32)
    else:
        out = torch.from_numpy(np.ascontiguousarray(nxts, dtype=np.int32)).to(device)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"annotations have shape {tuple(out.shape)}, the trace {tuple(shape)}")
    return out
