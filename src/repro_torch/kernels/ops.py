"""The kernel wrappers in one place, with their launch counts."""

from __future__ import annotations

from . import classify as _classify
from . import segsel as _segsel
from .classify import classify
from .segsel import segment_select, segment_select_batch

__all__ = ["classify", "launch_counts", "reset_launch_counts", "segment_select",
           "segment_select_batch"]


def launch_counts() -> dict:
    """Kernel launches since the last reset: per entry point for segsel, per
    call site for classify (``classify_gc``, ``classify_user``)."""
    return {**_segsel.launches, **_classify.launches}


def reset_launch_counts() -> None:
    for counts in (_segsel.launches, _classify.launches):
        for key in counts:
            counts[key] = 0
