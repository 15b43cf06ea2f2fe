"""Share of a query's time in which no operation ran on the device: 1 -
device busy time a query (the union of kernel, copy and set intervals in
the profiled stretch) / the measured window's time a query. The window
is not profiled, so the profiler's own slowing of the host (a query takes
14-49% longer under it) is not read as idle time."""


def read(run):
    s = run.stretch
    if s is None or s.queries <= 0 or s.busy_s <= 0 or run.queries <= 0:
        return None
    return 100.0 * (1.0 - (s.busy_s / s.queries)
                    / (run.window_s / run.queries))
