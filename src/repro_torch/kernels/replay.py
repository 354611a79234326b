"""The per-volume replay kernel: a whole fleet replay in one launch.

A state on the card goes to the hand-written kernel in ``csrc/replay.cu``
(one warp per volume runs every user write of its trace and its GC loop,
with victim selection and GC classification inside). The kernel's plain
version is the step engine of `core.torchsim` (`_user_write` and
`fleet_gc_tick` once per lockstep step), which `torchsim` runs for a state
on the CPU; this wrapper takes only CUDA tensors and raises on any other.
There is no fallback from one to the other. With ``cfg.timing`` the kernel
runs the timing model (its ``lat_*`` keys), and for idle_window volumes the
GC schedule's deferral, as the step engine does; each is an instance of the
kernel of its own, so the instance with both off runs none of it. The kernel
takes the five elementwise schemes; a fleet with a stateful one is refused
(`NotImplementedError` naming ROADMAP Queue 1 item 4b), and so is the legacy
GC engine (`ValueError`), never handed to the step engine, which runs both
under ``engine="step"``. ``launches`` counts the
kernel's launches: ``replay`` with the timing model off, ``replay_timing``
with it on.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core.config import GCSCHED_IDS, TorchSimConfig, state_spec
from ..core.placement.schemes import require_elementwise
from . import build

launches = {"replay": 0, "replay_timing": 0}   # the timing model's instances apart

# the state keys the kernel reads or writes, in the order of ReplayArgs in
# csrc/replay.cu; the stateful schemes' sch_* keys it leaves alone. The
# timing model's keys (TIMING_FIELDS) it touches only with cfg.timing, and
# p_gcsched only then or when some volume runs idle_window
TIMING_FIELDS = ("lat_now", "lat_busy", "lat_debt", "lat_charged", "lat_sum", "lat_max",
                 "lat_hist")
STATE_FIELDS = ("seg_lba", "seg_utime", "seg_valid", "seg_n", "seg_nvalid", "seg_cls",
                "seg_state", "seg_ctime", "seg_stime", "open_sid", "loc_seg", "loc_off",
                "last_uw", "t", "total_occ", "total_valid", "user_writes", "gc_writes",
                "reclaimed", "overflow", "ell", "ell_tot", "nc", "class_user", "class_gc",
                "lat_dens", *TIMING_FIELDS, "p_scheme", "p_selector", "p_gp", "p_ncw",
                "p_classes", "p_gcsched")
IDLE_WINDOW = GCSCHED_IDS["idle_window"]


class ReplayArgs(ctypes.Structure):
    _fields_ = ([(key, ctypes.c_void_p) for key in STATE_FIELDS]
                + [("trace", ctypes.c_void_p), ("iterations", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in ("n_volumes", "n_steps", "n_rows",
                                                     "seg_size", "n_classes", "n_lbas",
                                                     "max_gc")]
                + [("dens_keep", ctypes.c_float), ("dens_add", ctypes.c_float),
                   ("timing", ctypes.c_int), ("defer", ctypes.c_int)]
                + [(name, ctypes.c_float) for name in ("write_cost", "gc_block_cost",
                                                       "charge_cap", "idle_density", "ln2")]
                + [("watermark_rows", ctypes.c_int), ("lat_buckets", ctypes.c_int)])


_SIGNATURES = {"replay_launch": [ctypes.POINTER(ReplayArgs), ctypes.c_void_p],
               "replay_limits": [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]}


def check_inputs(cfg: TorchSimConfig, st: dict, trace) -> bool:
    """Raise unless ``cfg`` runs the tick engine (the legacy engine is
    refused first: it runs under ``engine="step"``), every state key is a
    contiguous tensor of its dtype and shape for ``cfg`` with one leading
    volume axis, ``trace`` a contiguous (V, T) int32 tensor of LBAs in
    [-1, n_lbas) (-1: a pad step) on the same device, every volume's scheme
    elementwise, that device CUDA, and the segment size and class slots
    within the kernel's limits. Returns whether
    some volume runs idle_window (`launch`'s ``defer``), read here with the
    other checks so that the launch itself makes no host sync."""
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
    if trace.numel() and bool(((trace < -1) | (trace >= cfg.n_lbas)).any()):
        raise ValueError(f"trace LBAs must lie in [0, {cfg.n_lbas}) or be -1 (a pad step)")
    require_elementwise(torch.unique(st["p_scheme"]).tolist())
    if device.type != "cuda":
        raise ValueError(f"the replay kernel takes CUDA tensors, not {device}; the step "
                         f"engine (torchsim.step_replay) is its plain version on the CPU")
    max_seg, max_cls = ctypes.c_int(), ctypes.c_int()
    build.library("replay", _SIGNATURES).replay_limits(ctypes.byref(max_seg),
                                                       ctypes.byref(max_cls))
    if cfg.segment_size > max_seg.value or cfg.n_class_slots > max_cls.value:
        raise ValueError(f"the replay kernel takes segment_size <= {max_seg.value} and at most "
                         f"{max_cls.value} class slots")
    return bool((st["p_gcsched"] == IDLE_WINDOW).any())


def launch(cfg: TorchSimConfig, st: dict, trace, iterations, defer: bool) -> None:
    """One launch of the kernel on inputs that passed `check_inputs`, with a
    zeroed (T,) int32 ``iterations`` buffer on the card that receives, per
    step, the most GC iterations any volume ran, and ``defer`` as
    `check_inputs` returned it. No host sync."""
    V, T = trace.shape
    device = trace.device
    a = np.float32(1.0 / cfg.density_window)
    f32 = [float(np.float32(x)) for x in (cfg.write_cost, cfg.gc_block_cost,
                                          cfg.gc_rate * cfg.gc_block_cost, cfg.idle_density,
                                          math.log(2.0))]
    args = ReplayArgs(*(st[key].data_ptr() for key in STATE_FIELDS), trace.data_ptr(),
                      iterations.data_ptr(), V, T, cfg.n_rows, cfg.segment_size,
                      cfg.n_class_slots, cfg.n_lbas, cfg.max_gc_per_step,
                      float(np.float32(1.0) - a), float(a), int(cfg.timing), int(defer),
                      *f32, cfg.watermark_rows, cfg.lat_buckets)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = build.library("replay", _SIGNATURES).replay_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"replay kernel launch failed with CUDA error {err}")
    # the C side launches nothing for no volumes
    launches["replay_timing" if cfg.timing else "replay"] += 1 if V else 0


def replay(cfg: TorchSimConfig, st: dict, trace, stats=None) -> None:
    """Replay the (V, T) int32 ``trace`` through the state ``st`` (made by
    `torchsim.own_state`, on the card) in place: per step, each volume's
    user write and its GC loop; a -1 step of a volume is skipped whole. With
    ``stats`` (a `torchsim.ReplayStats`), adds the steps, the steps whose GC
    loop ran and the fleet's tick iterations (per step, the most any volume
    ran), as the step engine counts them; they come back with one read after
    the launch, the replay's only host sync."""
    defer = check_inputs(cfg, st, trace)
    iterations = torch.zeros(trace.shape[1], dtype=torch.int32, device=trace.device)
    launch(cfg, st, trace, iterations, defer)
    if stats is not None:
        per_step = iterations.cpu()
        stats.steps += trace.shape[1]
        stats.gc_ticks += int((per_step > 0).sum())
        stats.tick_iterations += int(per_step.sum())
        stats.host_syncs += 1
