"""The entry's host side of a query: its latency minus its device span
(first device operation's start to last one's end), both from the
profiled stretch, averaged over the stretch's queries."""


def read(run):
    s = run.stretch
    if s is None or not s.host_ms:
        return None
    return sum(s.host_ms) / len(s.host_ms)
