"""Per job, in ms: the host's time preparing the traces before the replay,
the union of the port's ``gather``, ``check_lbas`` and ``next_writes``
spans inside the job spans, from the traced window."""

from portbench import spans


def read(run):
    return spans.per_job_ms(run, spans.PREP)
