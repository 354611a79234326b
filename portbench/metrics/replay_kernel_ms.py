"""Per job, in ms: device time of the replay kernel (rows named
``replay_kernel*``), from the traced window."""

from portbench import tracing


def kernel_rows(trace):
    return [r for r in trace.rows("kernel") if "replay_kernel" in r[0]]


def read(run):
    if run.trace is None:
        return None
    rows = kernel_rows(run.trace)
    if not rows:
        return None
    return sum(tracing.inside(rows, s, e) for s, e in run.trace.jobs) / len(run.trace.jobs) / 1e3
