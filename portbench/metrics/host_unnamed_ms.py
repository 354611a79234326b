"""Per job, in ms: the job's span minus the union of the device's rows and
the port's spans inside it, the host time no span names, from the traced
window."""

from portbench import spans, tracing


def read(run):
    if run.trace is None:
        return None
    named = spans.intervals(run.trace)
    if not named:
        return None
    named += [(s, e) for _, s, e in run.trace.device]
    left = [(e - s) - tracing.covered(named, s, e) for s, e in run.trace.jobs]
    return sum(left) / len(left) / 1e3
