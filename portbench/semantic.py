"""The replay's semantic bytes and the card's peaks: the yardstick of
``replay_roofline_pct``.

The count is the data a log-structured volume must move to do what the
trace asks, from the configuration and the counts a job returns, and
nothing of how the port lays out its state: no state key, no pool size, no
victim scan. A kernel that changes its layout or skips its scans is held
to the same work. Per volume:

- each user write: its LBA read from the trace (4 B); the LBA's mapping
  entry read and written (4 + 4 B: the previous block's place, to
  invalidate it, and the new one); its last write time read and written
  (4 + 4 B: SepBIT's lifespan v); the new block's record written (LBA and
  write time, 8 B: the GC class of a block is its age); the predecessor
  segment's valid count read and written (4 + 4 B). 36 B.
- each GC write (a live block moved): its record read and written
  (8 + 8 B) and its mapping entry written (4 B). 20 B.
- each reclaimed segment: its validity, one bit a block, read
  (``segment_size / 8`` B).
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (HBM3) data sheet: 3.35 TB/s at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
USER_WRITE_BYTES = 36
GC_WRITE_BYTES = 20


def replay_bytes(segment_size: int, user_writes: int, gc_writes: int, reclaimed: int) -> int:
    """The semantic bytes of a replay with these totals."""
    return (USER_WRITE_BYTES * user_writes + GC_WRITE_BYTES * gc_writes
            + (segment_size // 8) * reclaimed)


def roofline_pct(n_bytes: int, seconds: float) -> float:
    """The share of the HBM roofline: the bytes' least time at the peak
    over the time taken, in percent."""
    return 100.0 * n_bytes / HBM_BYTES_PER_S / seconds
