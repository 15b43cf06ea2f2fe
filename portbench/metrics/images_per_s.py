"""Images completed in the window over the whole window."""


def read(run):
    return run.queries * run.batch / run.window_s
