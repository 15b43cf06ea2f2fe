"""Set-up: seconds from the process's start to the first timed query
(loading, weights, the program's graph passes and capture, warm-up)."""


def read(run):
    return run.setup_s
