"""Share of a query's time in which no operation ran on the device.

One query in flight (a stream mix): 1 - device busy time a query (the
union of kernel, copy and set intervals in the profiled stretch) / the
measured window's time a query. The window is not profiled, so the
profiler's own slowing of the host (a query takes 14-49% longer under it)
is not read as idle time.

Queries sent ahead (an offline mix with ``ahead_seconds``): 1 - busy time /
the profiled stretch's length, both within the stretch, which runs the
window's loop. There the card's pace sets the window's, and the profiler
slows the card too (by 1-2% in a device-bound cell), so busy time over
the unprofiled window's would read below 0."""


def read(run):
    s = run.stretch
    if s is None or s.queries <= 0 or s.busy_s <= 0 or run.queries <= 0:
        return None
    if "ahead_seconds" in run.traffic:
        return 100.0 * (1.0 - s.busy_s / s.window_s)
    return 100.0 * (1.0 - (s.busy_s / s.queries)
                    / (run.window_s / run.queries))
