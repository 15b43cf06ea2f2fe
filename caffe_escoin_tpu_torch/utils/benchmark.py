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
    function that a real forward runs on cold inputs. Every set is run
    once first (warm-up). The device is that of the first tensor argument.

    On a CUDA device each call is timed by its own pair of CUDA events,
    recorded around the eager call, and the calls are not synchronised in
    between. The JAX timer reads the device span of one compiled program;
    the port's arms run eagerly, so where a call is bound by the host's
    dispatch the events include that dispatch: it is what an eager forward
    pays. On a CPU tensor each call is timed on the host clock (for the
    tests; no device number).
    """
    sets = list(arg_sets) if arg_sets else [args]
    dev = _device_of(sets[0])
    for s in sets:
        f(*s)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = []
        for i in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f(*sets[i % len(sets)])
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(dev)
        times = [s.elapsed_time(e) * 1e-3 for s, e in events]
    else:
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            f(*sets[i % len(sets)])
            times.append(time.perf_counter() - t0)
    return statistics.median(times)
