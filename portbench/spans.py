"""The port's own names for its host time, for the metric readers: the
profiler ranges it opens around its host phases (``repro_torch.*`` rows of
`tracing.Trace.host`) and its host counters (``kernels.ops.host_counts``).
A program without them (an older port) gives None, never an error."""

from __future__ import annotations

from portbench import tracing

PREFIX = "repro_torch."
# the phases before a replay's launch, and after its read-back
PREP = ("repro_torch.fleet.gather", "repro_torch.fleet.check_lbas",
        "repro_torch.fleet.next_writes")
SUMMARY = ("repro_torch.fleet.summaries", "repro_torch.fleet.regroup",
           "repro_torch.fleet.sweep_summary")


def intervals(trace, names=None) -> list:
    """(start, end) of the trace's host rows named in ``names``, or of every
    port span where ``names`` is None."""
    return [(s, e) for name, s, e in trace.host
            if (name in names if names is not None else name.startswith(PREFIX))]


def per_job_ms(run, names):
    """Per job, in ms: the time the union of the spans ``names`` covers
    inside the job spans; None without a trace or without such spans."""
    if run.trace is None:
        return None
    rows = intervals(run.trace, names)
    if not rows:
        return None
    jobs = run.trace.jobs
    return sum(tracing.covered(rows, s, e) for s, e in jobs) / len(jobs) / 1e3


def host_counts():
    """The port's host counters since the process started (or their last
    reset), or None where the port keeps none."""
    from repro_torch.kernels import ops
    counts = getattr(ops, "host_counts", None)
    return None if counts is None else counts()
