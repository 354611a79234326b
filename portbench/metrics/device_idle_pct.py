"""Share of the traced window, in percent, with no kernel, copy or memset
running on the device."""

from portbench import tracing


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - tracing.busy_us(run.trace) / (hi - lo))
