"""Set-up: from the process's start to the window's start (loading, the
weights, warming up, the first run's kernel builds), on the host clock."""

UNIT = "s"


def read(run):
    return run.setup_s
