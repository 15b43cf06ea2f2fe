"""Device operations (kernels, copies, sets) per query in the profiled
stretch."""


def read(run):
    s = run.stretch
    return None if s is None else s.ops_per_query
