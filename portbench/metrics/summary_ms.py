"""Per job, in ms: the host's time summarizing the read-back state, the
union of the port's ``summaries``, ``regroup`` and ``sweep_summary`` spans
inside the job spans, from the traced window."""

from portbench import spans


def read(run):
    return spans.per_job_ms(run, spans.SUMMARY)
