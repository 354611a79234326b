"""The dense placement-scheme table and the elementwise classifiers.

Scheme ids follow the JAX package's registration order (nosep 0, sepgc 1,
sepbit 2, fk 3, dac 4, ml 5, sfs 6, uw 7, gw 8, eti 9, mq 10, sfr 11,
fadac 12, warcip 13): the CUDA classify kernel and the state's ``p_scheme``
key take these ids as runtime values.

The elementwise schemes (nosep, sepgc, sepbit and the Exp#4 ablations uw and
gw) are stateless given the shared ℓ estimate: one
``fn(v, g, from_c1, is_gc, ell) -> cls`` serves user writes (``is_gc = 0``)
and GC rewrites (``is_gc = 1``). The nine stateful schemes keep per-LBA
tables in the state: `stateful` on the step engine, and
``kernels/csrc/stateful_ops.cuh`` in the replay kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

NOBIT = 2 ** 30          # int32 "no next write" sentinel


def _ew_nosep(v, g, from_c1, is_gc, ell):
    return torch.zeros(v.shape, dtype=torch.int32, device=v.device)


def _ew_sepgc(v, g, from_c1, is_gc, ell):
    return torch.where(is_gc != 0, 1, 0).to(torch.int32)


def _ew_sepbit(v, g, from_c1, is_gc, ell):
    """Algorithm 1: user writes 0/1 by the predecessor's lifespan v < ℓ; GC
    rewrites 2 if they come from class 0, else 3/4/5 by age g against 4ℓ,
    16ℓ."""
    user_cls = torch.where(v < ell, 0, 1)
    age_cls = (3 + (g >= 4.0 * ell).to(torch.int32)
               + (g >= 16.0 * ell).to(torch.int32))
    gc_cls = torch.where(from_c1 != 0, 2, age_cls)
    return torch.where(is_gc != 0, gc_cls, user_cls).to(torch.int32)


def _ew_uw(v, g, from_c1, is_gc, ell):
    """Exp#4 ablation UW: user classes 0/1 by lifespan, one GC class."""
    user_cls = torch.where(v < ell, 0, 1)
    return torch.where(is_gc != 0, 2, user_cls).to(torch.int32)


def _ew_gw(v, g, from_c1, is_gc, ell):
    """Exp#4 ablation GW: one user class, GC classes 1/2/3 by age."""
    age_cls = (1 + (g >= 4.0 * ell).to(torch.int32)
               + (g >= 16.0 * ell).to(torch.int32))
    return torch.where(is_gc != 0, age_cls, 0).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class SchemeDef:
    name: str
    n_classes: int
    requires_future: bool = False
    elementwise: Callable | None = None


SCHEMES = (
    SchemeDef("nosep", 1, elementwise=_ew_nosep),
    SchemeDef("sepgc", 2, elementwise=_ew_sepgc),
    SchemeDef("sepbit", 6, elementwise=_ew_sepbit),
    SchemeDef("fk", 6, requires_future=True),
    SchemeDef("dac", 6),
    SchemeDef("ml", 6),
    SchemeDef("sfs", 6),
    SchemeDef("uw", 3, elementwise=_ew_uw),
    SchemeDef("gw", 4, elementwise=_ew_gw),
    SchemeDef("eti", 3),
    SchemeDef("mq", 6),
    SchemeDef("sfr", 6),
    SchemeDef("fadac", 6),
    SchemeDef("warcip", 6),
)
SCHEME_IDS = {sd.name: i for i, sd in enumerate(SCHEMES)}
SCHEME_NAMES = tuple(sd.name for sd in SCHEMES)
SCHEME_CLASSES = tuple(sd.n_classes for sd in SCHEMES)
SCHEME_REQUIRES_FUTURE = tuple(sd.requires_future for sd in SCHEMES)
ELEMENTWISE_IDS = tuple(i for i, sd in enumerate(SCHEMES) if sd.elementwise is not None)
# the schemes whose ℓ refreshes take a FIFO-occupancy sample (numpy SepBIT's
# on_gc_segment, which uw inherits; gw overrides it without sampling)
FIFO_IDS = (SCHEME_IDS["sepbit"], SCHEME_IDS["uw"])


def scheme_id(name: str) -> int:
    if name not in SCHEME_IDS:
        raise ValueError(f"unknown placement scheme {name!r}; have {SCHEME_NAMES}")
    return SCHEME_IDS[name]


def check_ids(ids) -> None:
    """Raise for any scheme id outside the table."""
    for sid in ids:
        if not 0 <= int(sid) < len(SCHEMES):
            raise ValueError(f"scheme id {int(sid)} is outside the table (0..{len(SCHEMES) - 1})")


def elementwise_chain(scheme_id, v, g, from_c1, is_gc, ell, scheme_ids=None):
    """Classes for every elementwise scheme, selected per element by the
    runtime ``scheme_id`` (which, like ``ell``, broadcasts against ``v``);
    ``v`` and ``g`` are float32. Other ids give class 0. ``scheme_ids`` (a
    static tuple of ids) prunes the chain to the schemes a fleet actually
    runs. This is the plain version of the classify kernel (`kernels.ref`)."""
    out = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for sid in ELEMENTWISE_IDS:
        if scheme_ids is not None and sid not in scheme_ids:
            continue
        cls = SCHEMES[sid].elementwise(v, g, from_c1, is_gc, ell)
        out = torch.where(scheme_id == sid, cls, out)
    return out
