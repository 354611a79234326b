"""The traced window: device activity and the harness's job spans from
``torch.profiler``, reduced to intervals on one clock (microseconds).

Each job runs inside a ``record_function(JOB_SPAN)`` range, so its span and
the device's kernels and copies share the profiler's timeline. Device rows
are sorted into copies (``Memcpy*``), memsets and kernels by name.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

JOB_SPAN = "portbench.job"


@dataclass
class Trace:
    """Intervals (start, end) in microseconds: ``jobs`` the harness's job
    spans; ``device`` every device row as (name, start, end); ``host`` the
    other host-side rows as (name, start, end), for labelling idle gaps."""

    jobs: list = field(default_factory=list)
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window(self) -> tuple:
        return self.jobs[0][0], self.jobs[-1][1]

    def rows(self, kind: str) -> list:
        """Device rows of one kind: ``copy``, ``memset`` or ``kernel``."""
        return [r for r in self.device if row_kind(r[0]) == kind]


def row_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def union(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the union of ``intervals`` covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def inside(rows, lo: float, hi: float) -> float:
    """Summed length of the rows' parts that fall in [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for _, s, e in rows)


def busy_us(trace: Trace) -> float:
    """Device time in the window with some row running."""
    lo, hi = trace.window
    return covered([(s, e) for _, s, e in trace.device], lo, hi)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window (name,
    seconds) and the longest idle gaps, each named by the shortest host row
    that covers at least half of it, or, where only the job span does
    (Python and NumPy work), by the device row it follows."""
    lo, hi = trace.window
    per_op: dict = {}
    for name, s, e in trace.device:
        per_op[name] = per_op.get(name, 0.0) + max(0.0, min(e, hi) - max(s, lo))
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    gaps, t = [], lo
    for s, e in union([(s, e) for _, s, e in trace.device if e > lo and s < hi]) + [[hi, hi]]:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        cover = [(e - s, name) for name, s, e in trace.host
                 if min(e, g1) - max(s, g0) >= 0.5 * (g1 - g0)]
        label = min(cover)[1] if cover else (
            f"host (no torch op) after {_before(trace.device, g0)}")
        named.append([label, (g1 - g0) / 1e6])
    return {"device_ops": [[name, us / 1e6] for name, us in ops], "idle_gaps": named}


def short(name: str) -> str:
    """A device row's name without its template and argument lists."""
    name = name.removeprefix("void ").split("(anonymous namespace)::")[-1]
    return name.split("<")[0].split("(")[0].strip() or name[:60]


def _before(rows, t: float) -> str:
    ends = [(e, name) for name, _, e in rows if e <= t]
    return short(max(ends)[1]) if ends else "the job's start"


@contextlib.contextmanager
def profiled(enabled: bool):
    """A ``torch.profiler`` session over CPU and CUDA activity when
    ``enabled`` (yields the profiler, or None)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def job_span(enabled: bool):
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(JOB_SPAN)


def from_profiler(prof) -> Trace:
    """The trace of a finished profiler session."""
    tr = Trace()
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type.name == "CUDA":
            if e.name != JOB_SPAN:      # the range's device-side annotation: no work
                tr.device.append((e.name, s, t))
        elif e.name == JOB_SPAN:
            tr.jobs.append((s, t))
        else:
            tr.host.append((e.name, s, t))
    tr.jobs.sort()
    return tr
