"""The program's own spans and counters (``caffe_escoin_tpu_torch/utils/
trace``) in a traced run, read after ``traced.py``'s readings, for the
program (``PortSystem``) alone:

1. the set-up aggregates, which the program always records;
2. an unprofiled stretch: four blocks of ``trace_queries`` queries of the
   loop, the program's tracing off, on, on, off. It gives the entry's
   spans per query (``entry`` and its phases ``entry:signature``,
   ``entry:copy_in``, ``entry:replay``) and the cost of tracing (the
   median latencies with tracing on and off);
3. a profiled stretch: ``trace_queries`` queries with tracing on, inside
   the same ``pb:query`` / ``pb:issue`` / ``pb:to_host`` spans as
   ``traced.py``'s stretch. The program's spans are ``cet:`` events on the
   profile's host timeline. It gives each query's bounds on the
   host-device clock offset from causality (what a span launched cannot
   start on the device before the host entered the span; the host cannot
   return from ``pb:to_host`` before the logits' copy ended), and each
   idle gap of the device charged by overlap to the innermost program span
   open on the host, the rest to the host waiting in ``pb:to_host``
   (``to_host``) or to no span of the program (``outside``). The two
   timelines drift apart within a stretch (0.07-17 ms over a second-long
   stretch, measured on an H100 host), so each query is read on its own
   bounds.

The program's spans are recorded only while its tracing is on, and it is
on only inside these stretches: the readings of ``traced.py`` hold no
``cet:`` event. Here operations exclude every ``cet:`` and ``pb:`` event.
The profiler projects a device operation onto the innermost span open at
its launch only, so in the profiled stretch the program's spans inside
``pb:issue`` take its device-side range.

``harness._traced`` does not call ``read`` yet (that is an edit to
``harness.py`` and ``system.py``). To run a cell with these readings
after the others::

    python3 -m portbench.program_trace --workload <cell> --seed <n> \\
        --seconds <s>

which prints the run's result line, then ``{"program": readings}``.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench import traced

TRACE_MODULE = "caffe_escoin_tpu_torch.utils.trace"
PROGRAM = "cet:"
LAYER = PROGRAM + "layer:"
ENTRY = "entry"
PHASES = ("entry:signature", "entry:copy_in", "entry:replay")
TO_HOST, OUTSIDE = "to_host", "outside"


def program_trace():
    """The program's trace module where the program is loaded (it imports
    it), else None: a reference in the program's place, or a program
    without spans."""
    return sys.modules.get(TRACE_MODULE)


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def split(events) -> Tuple[List[traced.Op], List[traced.Span],
                           List[traced.Span]]:
    """(device operations, host spans, device-side spans): operations are
    the device events that are neither the program's spans nor the
    benchmark's; host spans are both kinds of span on the host; the
    device-side spans are their projections onto the device (the profiler
    projects an operation onto the innermost span open when it was
    launched)."""
    ops, host, dev = [], [], []
    for e in events:
        r = e.time_range
        if not e.name.startswith((PROGRAM, traced.PREFIX)):
            if _is_device(e):
                ops.append(traced.Op(e.name, r.start, r.end))
        else:
            (dev if _is_device(e) else host).append(
                traced.Span(e.name, r.start, r.end))
    for xs in (ops, host, dev):
        xs.sort(key=lambda s: s.start)
    return ops, host, dev


def offsets(host: List[traced.Span], dev: List[traced.Span]
            ) -> Optional[List[Tuple[float, float]]]:
    """Each query's bounds (lo, hi), in us, on delta = device clock - host
    clock: delta <= d_start - h_start for every span with a device-side
    projection in every query (what it launched starts after the host
    entered it: ``pb:issue``, or with the program's tracing on the
    program's spans inside it, which then take its operations), and delta
    >= d_end - h_end for its ``pb:to_host`` (the logits' copy ends before
    the host returns). None unless every query has both."""
    h_copy = [s for s in host if s.name == traced.TO_HOST]
    d_copy = [s for s in dev if s.name == traced.TO_HOST]
    n = len(h_copy)
    if not n or len(d_copy) != n:
        return None
    his = [math.inf] * n
    for name in {s.name for s in dev}:
        h = [s for s in host if s.name == name]
        d = [s for s in dev if s.name == name]
        if len(h) == len(d) == n:
            his = [min(u, y.start - x.start) for u, x, y in zip(his, h, d)]
    return [(y.end - x.end, hi) for x, y, hi in zip(h_copy, d_copy, his)]


def flatten(spans: List[traced.Span]) -> List[Tuple[float, float, str]]:
    """Nested spans as disjoint segments, each named after the innermost
    span open over it."""
    out: List[Tuple[float, float, str]] = []
    stack: List[traced.Span] = []
    t = 0.0

    def advance(to):
        nonlocal t
        if stack and to > t:
            out.append((t, to, stack[-1].name))
        t = max(t, to)

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= s.start:
            advance(stack[-1].end)
            stack.pop()
        advance(s.start)
        stack.append(s)
    while stack:
        advance(stack[-1].end)
        stack.pop()
    return out


def _overlap(segments, starts, a: float, b: float):
    """(name, us) of each segment overlapping [a, b]."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(segments) and segments[i][0] < b:
        s, e, name = segments[i]
        if e > a:
            yield name, min(e, b) - max(s, a)
        i += 1


def _gaps(busy, starts, lo: float, hi: float):
    """The idle intervals inside [lo, hi] of ``busy``, sorted disjoint
    intervals (``traced.union``) that start at ``starts``."""
    out, t = [], lo
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    while i < len(busy) and busy[i][0] < hi:
        a, b = busy[i]
        if a > t:
            out.append((t, a))
        t = max(t, b)
        i += 1
    if t < hi:
        out.append((t, hi))
    return out


def charge_idle(ops: List[traced.Op], host: List[traced.Span],
                windows) -> Dict[str, float]:
    """Seconds of the device's idle time in each window (lo, hi, shift):
    [lo, hi] on the device's clock, put on the host's by taking ``shift``
    us. Each idle interval is charged by overlap to the innermost program
    span open on the host over it (its name without ``cet:``), to
    ``to_host`` where the host was in ``pb:to_host`` and in no program
    span, and to ``outside`` for the rest."""
    segments = flatten([s for s in host if s.name.startswith(PROGRAM)
                        or s.name == traced.TO_HOST])
    starts = [s[0] for s in segments]
    busy = traced.union((o.start, o.end) for o in ops)
    busy_starts = [b[0] for b in busy]
    out = collections.Counter()
    for lo, hi, shift in windows:
        for a, b in _gaps(busy, busy_starts, lo, hi):
            a, b = a - shift, b - shift
            left = b - a
            for name, us in _overlap(segments, starts, a, b):
                out[name[len(PROGRAM):] if name.startswith(PROGRAM)
                    else TO_HOST] += us / 1e6
                left -= us
            out[OUTSIDE] += max(left, 0.0) / 1e6
    return dict(out)


def read_profiled(events) -> Optional[dict]:
    """The profiled stretch's clock offset and idle charges; None without
    device operations, or without both causality bounds in every query.
    A query whose bounds hold 0 is read on one clock; the device's times
    of any other are shifted by its bounds' midpoint, and the reader logs
    how many were."""
    ops, host, dev = split(events)
    queries = [s for s in host if s.name == traced.QUERY]
    bounds = offsets(host, dev)
    if not ops or bounds is None or len(bounds) != len(queries):
        return None
    shifts = [0.0 if lo <= 0.0 <= hi else (lo + hi) / 2
              for lo, hi in bounds]
    moved = sum(1 for x in shifts if x)
    if moved:
        print(f"program_trace: {moved} of {len(queries)} queries' bounds "
              f"exclude a shared clock: their device times shifted by "
              f"{min(shifts):.3f} to {max(shifts):.3f} us",
              file=sys.stderr, flush=True)
    edges = [q.start + x for q, x in zip(queries, shifts)]
    edges.append(queries[-1].end + shifts[-1])
    idle = charge_idle(ops, host, [(edges[i], edges[i + 1], shifts[i])
                                   for i in range(len(queries))])
    total = sum(idle.values())
    in_entry = sum(x for k, x in idle.items()
                   if k == ENTRY or k.startswith(ENTRY + ":"))
    lo, hi = max(b[0] for b in bounds), min(b[1] for b in bounds)
    return {"offset_us": [lo, hi], "offset_zero_inside": lo <= 0.0 <= hi,
            "queries_shifted": moved, "shift_us": [min(shifts), max(shifts)],
            "idle_s": total,
            "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "idle_in_entry_pct": 100.0 * in_entry / total if total else None}


def charge_layers(events, forwards: int) -> Dict[str, float]:
    """``traced.charge_layers`` by the program's ``cet:layer:`` spans."""
    ops, _, _ = split(events)
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len(LAYER):]) for e in events
                   if _is_device(e) and e.name.startswith(LAYER))
    starts = [s[0] for s in spans]
    out = collections.Counter()
    for o in ops:
        i = bisect.bisect_right(starts, o.start) - 1
        if i >= 0 and o.start <= spans[i][1]:
            out[spans[i][2]] += (o.end - o.start) / forwards
    return dict(out)


def _delta(before: dict, after: dict) -> dict:
    """Span and counter aggregates added between two snapshots."""
    spans = {}
    for name, s in after["spans"].items():
        b = before["spans"].get(name, {"count": 0, "total_s": 0.0,
                                       "self_s": 0.0})
        if s["count"] > b["count"]:
            spans[name] = {k: s[k] - b[k] for k in ("count", "total_s",
                                                    "self_s")}
    counters = {k: n - before["counters"].get(k, 0)
                for k, n in after["counters"].items()
                if n != before["counters"].get(k, 0)}
    return {"spans": spans, "counters": counters}


def _loop(system, pool, n0: int, queries: int) -> List[float]:
    n_pool = pool.shape[0]
    lat = []
    for i in range(queries):
        t0 = time.perf_counter()
        system.query(pool[(n0 + i) % n_pool])
        lat.append(time.perf_counter() - t0)
    return lat


def read(run, system, pool, n0: int, device) -> Optional[dict]:
    """The three readings for ``system`` after ``traced.py``'s, or None
    where no program with spans is loaded or ``system`` is not it."""
    from portbench.system import PortSystem

    tr = program_trace()
    if tr is None or not isinstance(system, PortSystem):
        return None
    queries = run.traffic["trace_queries"]
    setup = {k: v for k, v in tr.snapshot()["spans"].items()
             if k.startswith("setup:")}
    out = {"setup": setup}

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = tr.snapshot()
    lat = {False: [], True: []}
    for on in (False, True, True, False):  # tracing off and on, in turn
        if on:
            tr.enable()
        try:
            lat[on] += _loop(system, pool, n0, queries)
        finally:
            tr.disable()
    got = _delta(before, tr.snapshot())
    entry = got["spans"].get(ENTRY)
    calls = len(lat[True])
    out["unprofiled"] = {
        "queries": calls,
        "latency_ms_p50_off": statistics.median(lat[False]) * 1e3,
        "latency_ms_p50_on": statistics.median(lat[True]) * 1e3,
        "latency_ms_p50_window": statistics.median(run.latency_s) * 1e3,
        "entry_span_ms": (entry["total_s"] / entry["count"] * 1e3
                          if entry else None),
        "phases_ms": {k: got["spans"][k]["total_s"] / calls * 1e3
                      for k in (ENTRY, *PHASES) if k in got["spans"]},
        "entry_self_ms": entry["self_s"] / calls * 1e3 if entry else None,
        "counters": got["counters"]}

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    rf = torch.profiler.record_function
    n_pool = pool.shape[0]
    tr.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(queries):
                x = pool[(n0 + i) % n_pool]
                with rf(traced.QUERY):
                    with rf(traced.ISSUE):
                        y = system.issue(x)
                    with rf(traced.TO_HOST):
                        system.to_host(y)
    finally:
        tr.disable()
    out["profiled"] = read_profiled(prof.events())
    out["counters"] = tr.snapshot()["counters"]
    return out


def main(argv=None) -> int:
    """``portbench/run.py``'s run of one cell with ``--trace 1``, these
    readings after the others; the last line is ``{"program": ...}``."""
    from portbench import harness, run

    argv = list(sys.argv[1:] if argv is None else argv)
    readings: dict = {}
    original = harness._traced

    def traced_then_program(r, system, pool, n0, device):
        breakdown = original(r, system, pool, n0, device)
        readings.update(read(r, system, pool, n0, device) or {})
        return breakdown

    harness._traced = traced_then_program
    try:
        rc = run.main(argv + ["--trace", "1"])
    finally:
        harness._traced = original
    if rc == 0:
        print(json.dumps({"program": readings}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
