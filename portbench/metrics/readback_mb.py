"""Per job, in MB: the bytes of state the port hands to the host
(``state_readback_bytes``) over its fleet summaries, one a job (both from
the port's counters, so warm-up jobs cancel out)."""

from portbench import spans


def read(run):
    counts = spans.host_counts()
    if not counts or not counts["fleet_summaries"]:
        return None
    return counts["state_readback_bytes"] / counts["fleet_summaries"] / 1e6
