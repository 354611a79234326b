"""In-place state updates of the step engine and its device constants.

The engine updates its state in place (JAX's arrays are immutable; here a
fleet's segment arrays run to hundreds of MB) on a private copy made by
`own_state`. Each tensor of that copy has one spare element past its end:
a scatter aims every entry that JAX would drop (``mode="drop"``) at that
element (`Consts.kept`, `put`), so a masked write changes nothing and costs
no host sync.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .placement.schemes import FIFO_IDS, SCHEMES

IDLE_WINDOW = 2     # config.GCSCHED_IDS["idle_window"]


def own_state(state: dict) -> dict:
    """A copy of ``state`` that the engine may update in place: each tensor
    contiguous, with one spare element past its end (see `put`)."""
    out = {}
    for key, x in state.items():
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out[key] = buf[:-1].view(x.shape)
        out[key].copy_(x)
    return out


def put(x, idx, values):
    """``x.view(-1)[idx] = values``, where ``idx`` may name the spare element
    past the end of ``x`` (see `own_state`, `Consts.kept`): entries aimed
    there leave ``x`` as it was — JAX's ``mode="drop"``. Among the other
    entries, a repeated index keeps one of its values, as in JAX."""
    x.as_strided((x.numel() + 1,), (1,)).index_put_((idx,), values)


def add(x, flat, values):
    """``x.view(-1)[flat] += values``, repeated indices accumulating."""
    x.view(-1).scatter_add_(0, flat.reshape(-1), values.reshape(-1))


class Consts:
    """Device constants of one replay over V volumes, made once: rebuilding
    index bases every step would cost launches, and a tensor made from a
    host value would cost a host-to-device copy each time.

    ``p_scheme`` (the state's (V,) scheme ids) is read once, to learn which
    stateful schemes the fleet runs (``stateful``, their ids in table
    order) and which volumes run each (``member[sid]``, (V,) bool).
    ``p_gcsched`` is read once, to learn whether some volume runs
    idle_window (``idle_window``), whose defer predicate the GC loop then
    evaluates.

    ``f32`` holds the timing model's float32 constants as tensors, so that
    the card divides by a tensor as the CPU does (CUDA divides by a Python
    number through its reciprocal)."""

    def __init__(self, cfg, V: int, device, p_scheme=None, p_gcsched=None):
        R, s, C, n = cfg.n_rows, cfg.segment_size, cfg.n_class_slots, cfg.n_lbas
        i32 = {"dtype": torch.int32, "device": device}
        self.vol = torch.arange(V, device=device)
        self.device = device
        self.row0 = self.vol * R        # each volume's first flat row of a (V, R) array
        self.lba0 = self.vol * n        # ... of a (V, n_lbas) array
        self.cls0 = self.vol * C        # ... of a (V, C) array
        self.cls_ids = torch.arange(C, **i32)
        self.slots = torch.arange(s, device=device)
        self.rank1 = torch.ones((V, 1), **i32)          # free-row ranks for one row
        self.rankC = torch.arange(1, C + 1, **i32).expand(V, C).contiguous()
        self.zeros_v1 = torch.zeros((V, 1), **i32)
        self.zeros_vs = torch.zeros((V, s), **i32)
        self.ones_vs = torch.ones((V, s), **i32)
        self.ones_v = torch.ones(V, **i32)
        self.true = torch.ones((), dtype=torch.bool, device=device)
        self.false = torch.zeros((), dtype=torch.bool, device=device)
        self.i32 = {c: torch.full((), c, **i32) for c in (-1, 0, 1, 2, 3)}
        self.zero_f = torch.zeros((), dtype=torch.float32, device=device)
        self._spare: dict[int, torch.Tensor] = {}
        self._base = {n: self.lba0}
        ids = [] if p_scheme is None else sorted(int(i) for i in torch.unique(p_scheme).tolist())
        self.stateful = tuple(i for i in ids if SCHEMES[i].elementwise is None)
        self.member = {i: p_scheme == i for i in self.stateful}
        self.idle_window = p_gcsched is not None and bool((p_gcsched == IDLE_WINDOW).any())
        self.fifo = (torch.isin(p_scheme, torch.tensor(FIFO_IDS, dtype=p_scheme.dtype,
                                                        device=device))
                     if cfg.fifo_occupancy and p_scheme is not None else None)
        self.f32 = {name: torch.tensor(np.float32(x), device=device) for name, x in (
            ("write_cost", cfg.write_cost), ("gc_block_cost", cfg.gc_block_cost),
            ("charge_cap", cfg.gc_rate * cfg.gc_block_cost), ("idle_density", cfg.idle_density),
            ("ln2", math.log(2.0)))}

    def kept(self, x, flat, keep):
        """``flat`` where ``keep``, else the index of ``x``'s spare element."""
        n = x.numel()
        if n not in self._spare:
            self._spare[n] = torch.full((), n, dtype=torch.int64, device=self.device)
        return torch.where(keep, flat, self._spare[n])

    def base(self, width: int) -> torch.Tensor:
        """(V,) int64: each volume's first flat index of a (V, width) array."""
        if width not in self._base:
            self._base[width] = self.vol * width
        return self._base[width]
