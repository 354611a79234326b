"""The kernel wrappers in one place, and the port's one registry of counts:
each count is a module-level dict at its site (a kernel's ``launches``,
`convert.readback`, `core.torchsim.summary_counts` and ``trace_counts``),
read here and zeroed by `reset_launch_counts`."""

from __future__ import annotations

from .. import convert as _convert
from ..core import torchsim as _torchsim
from . import classify as _classify
from . import decode_attn as _decode_attn
from . import replay as _replay
from . import segsel as _segsel
from . import zipfprob as _zipfprob
from .classify import classify
from .decode_attn import flash_decode
from .replay import replay
from .segsel import segment_select, segment_select_batch
from .zipfprob import pr_gc_bit_kernel, pr_user_bit_kernel, zipf_bit_sums, zipf_bit_sums_batch

__all__ = ["classify", "flash_decode", "host_counts", "launch_counts", "point_counts",
           "pr_gc_bit_kernel", "pr_user_bit_kernel", "replay", "reset_launch_counts",
           "segment_select", "segment_select_batch", "zipf_bit_sums", "zipf_bit_sums_batch"]

_COUNTERS = (_segsel.launches, _classify.launches, _zipfprob.launches, _decode_attn.launches,
             _replay.launches)
_HOST = (_convert.readback, _torchsim.summary_counts, _torchsim.trace_counts)


def launch_counts() -> dict:
    """Kernel launches since the last reset: per entry point for segsel, per
    call site for classify (``classify_gc``, ``classify_user``), one count
    each for ``zipf_bit_sums`` and ``flash_decode``, and for the replay
    kernel ``replay`` (timing model off) and ``replay_timing`` (on)."""
    return {k: n for counts in _COUNTERS for k, n in counts.items()}


def point_counts() -> dict:
    """Points evaluated by the kernel launches since the last reset: one
    count, ``zipf_bit_sums``, for the Zipf sums' batches."""
    return dict(_zipfprob.points)


def host_counts() -> dict:
    """The host's counts since the last reset: ``state_readback_bytes``, the
    bytes of state `convert.state_to_numpy` handed to the host;
    ``fleet_summaries``, the calls of `torchsim.summarize_fleet`;
    ``summary_bytes``, the bytes of state its per-volume summaries read; and
    ``trace_copy_bytes``, the bytes of trace rows the fleet API copied on
    the host (0 where its row selections were views)."""
    return {k: n for counts in _HOST for k, n in counts.items()}


def reset_launch_counts() -> None:
    """Zero every count of the registry: the launch, point and host counts."""
    for counts in (*_COUNTERS, _zipfprob.points, *_HOST):
        for key in counts:
            counts[key] = 0
