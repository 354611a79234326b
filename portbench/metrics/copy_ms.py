"""Per job, in ms: device time of the host-to-device and device-to-host
copies, from the traced window."""

from portbench import tracing


def read(run):
    if run.trace is None:
        return None
    rows = run.trace.rows("copy")
    if not rows:
        return None
    return sum(tracing.inside(rows, s, e) for s, e in run.trace.jobs) / len(run.trace.jobs) / 1e3
