"""Timing of one callable on the device (port of
``caffe_escoin_tpu/utils/benchmark.py``: ``device_time`` only)."""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("device_time: no tensor among the arguments")


def device_time(f: Callable, *args, iters: int = 20,
                arg_sets=None) -> float:
    """Median seconds per call of ``f(*args)``.

    ``arg_sets`` (a list of argument tuples, cycled across the calls; pass
    4 or more distinct ones) keeps an input from staying in the 50 MB L2
    from one call to the next, which would under-report a memory-bound
    function that a real forward runs on cold inputs. The device is that
    of the first tensor argument.

    On a CUDA device it times the device alone, as the JAX timer reads the
    device span of one compiled program: every argument set is first run
    once eagerly (where autotune measures a key it has not seen and the
    kernels build their plans and workspaces), then ``f(*s)`` is captured
    once per set as a CUDA graph, each graph is replayed once untimed, and
    then the graphs are replayed in turn ``iters`` times, each replay
    between its own pair of CUDA events. The graphs are freed before it
    returns. ``f`` must be capturable: it reads no device value on the
    host. On a CPU tensor each eager call is timed on the host clock (for
    the tests; no device number).
    """
    sets = list(arg_sets) if arg_sets else [args]
    dev = _device_of(sets[0])
    for s in sets:
        f(*s)
    if dev.type != "cuda":
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            f(*sets[i % len(sets)])
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
    graphs = []
    try:
        for s in sets:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                f(*s)
            graphs.append(graph)
        for graph in graphs:  # the first launch of a graph uploads it
            graph.replay()
        events = []
        for i in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[i % len(graphs)].replay()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(dev)
        return statistics.median(s.elapsed_time(e) * 1e-3
                                 for s, e in events)
    finally:
        del graphs
