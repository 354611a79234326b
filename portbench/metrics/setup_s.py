"""Seconds from the process's start to the end of the warm-up jobs: imports,
the kernel build (first run in a checkout only), the corpus made on the card
and brought to the host, the job's inputs laid out, two whole jobs."""


def read(run):
    return run.setup_s
