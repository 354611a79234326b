"""The replay kernel's share of its HBM roofline, in percent: a job's
semantic bytes (`portbench.semantic`, from the configuration and the counts
the job returned) at 3.35 TB/s over the kernel's device time in the job."""

from portbench import semantic
from portbench.metrics import reader


def read(run):
    kernel_ms = reader("replay_kernel_ms")(run)
    if not kernel_ms or not run.outs:
        return None
    o = run.outs[0]
    n_bytes = semantic.replay_bytes(run.config["segment_size"], int(o["user_writes"].sum()),
                                    int(o["gc_writes"].sum()), int(o["reclaimed"].sum()))
    return semantic.roofline_pct(n_bytes, kernel_ms / 1e3)
