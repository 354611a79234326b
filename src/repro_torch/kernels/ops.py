"""The kernel wrappers in one place, with their launch counts."""

from __future__ import annotations

from . import classify as _classify
from . import decode_attn as _decode_attn
from . import segsel as _segsel
from . import zipfprob as _zipfprob
from .classify import classify
from .decode_attn import flash_decode
from .segsel import segment_select, segment_select_batch
from .zipfprob import pr_gc_bit_kernel, pr_user_bit_kernel, zipf_bit_sums

__all__ = ["classify", "flash_decode", "launch_counts", "pr_gc_bit_kernel",
           "pr_user_bit_kernel", "reset_launch_counts", "segment_select",
           "segment_select_batch", "zipf_bit_sums"]

_COUNTERS = (_segsel.launches, _classify.launches, _zipfprob.launches, _decode_attn.launches)


def launch_counts() -> dict:
    """Kernel launches since the last reset: per entry point for segsel, per
    call site for classify (``classify_gc``, ``classify_user``), and one
    count each for ``zipf_bit_sums`` and ``flash_decode``."""
    return {k: n for counts in _COUNTERS for k, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for key in counts:
            counts[key] = 0
