"""Per job, in ms: the job's span minus the time the device was busy inside
it (any kernel, copy or memset running), from the traced window."""

from portbench import tracing


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    dev = [(s, e) for _, s, e in run.trace.device]
    idle = [(e - s) - tracing.covered(dev, s, e) for s, e in run.trace.jobs]
    return sum(idle) / len(idle) / 1e3
