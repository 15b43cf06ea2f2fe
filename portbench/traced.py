"""What a ``--trace 1`` run reads from ``torch.profiler``.

Two recordings, both after the measured window:

* the stretch: ``trace_queries`` queries of the timed loop under the
  profiler (CPU and CUDA activities), each inside a ``pb:query`` span with
  its host phases ``pb:issue`` (the entry: copy-in and the graph's
  launch) and ``pb:to_host`` (the logits' copy and the wait for it). It
  gives the device's busy time (the union of its kernel, copy and set
  intervals), the window (first query's start to last query's end on the
  host), the operations per query, each query's host time beyond its
  device span, and where the device sat idle;
* the layer-stepped forwards: eager forwards through the program's
  ``Net.forward(layer_hook=...)``, a ``pb:layer:<name>`` span open from a
  layer's hook call to the next one's (or the forward's end). A kernel is
  charged to the layer whose span, projected onto the device's timeline,
  holds the kernel's start: the arithmetic of
  ``caffe_escoin_tpu_torch/experiments/opprofile.aggregate``, copied.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "pb:"
LAYER = PREFIX + "layer:"
QUERY, ISSUE, TO_HOST = PREFIX + "query", PREFIX + "issue", PREFIX + "to_host"
# the hand kernels, by the Rows policy their sconv_pipe_kernel instance is
# named after in a trace (caffe_escoin_tpu_torch/csrc/sconv_pipe.cuh)
KERNEL_OF_ROWS = {"ConvRows": "sconv_fused", "SlabRows": "sconv_gc",
                  "DenseRows": "bsc_spmm"}
TOP = 10
NAME_CHARS = 120


def kernel_of(name: str) -> str:
    for rows, kernel in KERNEL_OF_ROWS.items():
        if rows in name:
            return kernel
    return name


@dataclasses.dataclass
class Op:
    name: str
    start: float  # us, the profiler's clock
    end: float


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def split(events) -> Tuple[List[Op], List[Span], List[Span]]:
    """(device operations, host spans, device-side spans) of a profile's
    events: the kernels, copies and sets; this module's ``pb:`` spans on
    the host; and their projections onto the device's timeline."""
    ops, host, dev = [], [], []
    for e in events:
        r = e.time_range
        if e.name.startswith(PREFIX):
            (dev if _is_device(e) else host).append(
                Span(e.name, r.start, r.end))
        elif _is_device(e):
            ops.append(Op(e.name, r.start, r.end))
    ops.sort(key=lambda o: o.start)
    host.sort(key=lambda s: s.start)
    dev.sort(key=lambda s: s.start)
    return ops, host, dev


def union(intervals) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(ops: List[Op], lo: float, hi: float) -> float:
    return sum(min(b, hi) - max(a, lo) for a, b in
               union((o.start, o.end) for o in ops) if b > lo and a < hi)


def gaps(ops: List[Op], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of the device inside [lo, hi]."""
    out, t = [], lo
    for a, b in union((o.start, o.end) for o in ops):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Stretch:
    """The profiled stretch of the timed loop."""

    queries: int
    window_s: float
    busy_s: float
    ops_per_query: float
    host_ms: List[float]  # per query: latency minus its device span
    top_ops: List[Tuple[str, float]]
    idle_by_place: List[Tuple[str, float]]


def _inside(starts: List[float], spans: List[Span], a: float,
            b: float) -> bool:
    i = bisect.bisect_right(starts, a) - 1
    return i >= 0 and b <= spans[i].end


def read_stretch(events) -> Optional[Stretch]:
    """The stretch's numbers. Host and device timestamps are compared only
    within their own clock: a query's device span runs from the start of
    the device-side projection of its ``pb:issue`` span (its first
    operation) to the end of its ``pb:to_host`` one (the logits' copy),
    its latency is its host-side ``pb:query`` span; an idle interval of
    the device is placed by the device-side spans around it: inside the
    entry's copy-in and replay (``replay``), inside the logits' copy
    (``to_host``), or between two queries (``turnaround``: the host's
    return, its loop and its next launch)."""
    ops, host, dev = split(events)
    qs = [s for s in host if s.name == QUERY]
    if not qs or not ops:
        return None
    window_us = qs[-1].end - qs[0].start
    issues = [s for s in dev if s.name == ISSUE]
    copies = [s for s in dev if s.name == TO_HOST]
    host_ms = ([(q.end - q.start - (c.end - i.start)) / 1e3
                for q, i, c in zip(qs, issues, copies)]
               if len(issues) == len(copies) == len(qs) else [])
    by_name = collections.Counter()
    for o in ops:
        by_name[o.name] += (o.end - o.start) / 1e6
    busy = busy_us(ops, ops[0].start, max(o.end for o in ops))
    places = [(name, [s.start for s in spans], spans)
              for name, spans in (("replay", issues), ("to_host", copies))]
    idle = collections.Counter()
    inner = 0.0
    for a, b in gaps(ops, ops[0].start, max(o.end for o in ops)):
        place = next((name for name, starts, spans in places
                      if _inside(starts, spans, a, b)), "turnaround")
        idle[place] += (b - a) / 1e6
        inner += b - a
    # the window's idle time before the first and after the last operation
    idle["turnaround"] += max(0.0, window_us - busy - inner) / 1e6
    return Stretch(
        queries=len(qs), window_s=window_us / 1e6,
        busy_s=busy / 1e6, ops_per_query=len(ops) / len(qs),
        host_ms=host_ms,
        top_ops=[(n[:NAME_CHARS], s) for n, s in by_name.most_common(TOP)],
        idle_by_place=idle.most_common(TOP))


class LayerSpans:
    """A ``layer_hook`` that opens a span per layer and closes it at the
    next layer's hook call; ``close`` ends the last one."""

    def __init__(self):
        self._open = None

    def hook(self, layer, params):
        self.close()
        self._open = torch.profiler.record_function(LAYER + layer.spec.name)
        self._open.__enter__()
        return params, None

    def close(self):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


def charge_layers(events, forwards: int) -> Dict[str, float]:
    """Device us per forward charged to each layer: an operation belongs to
    the layer whose device-side span holds its start (copies and sets
    included); operations outside every span are charged to no layer."""
    ops, _, dev = split(events)
    spans = sorted((s.start, s.end, s.name[len(LAYER):]) for s in dev
                   if s.name.startswith(LAYER))
    starts = [s[0] for s in spans]
    out = collections.Counter()
    for o in ops:
        i = bisect.bisect_right(starts, o.start) - 1
        if i >= 0 and o.start <= spans[i][1]:
            out[spans[i][2]] += (o.end - o.start) / forwards
    return dict(out)


def hand_kernels(events) -> Dict[str, int]:
    """Calls of each hand kernel (by its Rows policy) among the device
    operations."""
    ops, _, _ = split(events)
    out = collections.Counter(kernel_of(o.name) for o in ops)
    return {k: out[k] for k in KERNEL_OF_ROWS.values()}
