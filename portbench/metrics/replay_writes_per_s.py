"""User writes replayed per second: the writes of every job completed in the
window over the time from the first job's start to the last job's end."""


def read(run):
    if not run.jobs:
        return None
    return sum(w for _, _, w in run.jobs) / (run.jobs[-1][1] - run.jobs[0][0])
