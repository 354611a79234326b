"""Share of the state read back to the host, in percent, that the port's
summaries read (``summary_bytes`` over ``state_readback_bytes``, from the
port's counters)."""

from portbench import spans


def read(run):
    counts = spans.host_counts()
    if not counts or not counts["state_readback_bytes"]:
        return None
    return 100.0 * counts["summary_bytes"] / counts["state_readback_bytes"]
