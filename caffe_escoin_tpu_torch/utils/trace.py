"""The program's spans and counters.

A span is a named stretch of host time; a counter a named count. Both
add into aggregates kept in this module, per name: a span's count, total
and maximum time on ``time.perf_counter_ns``, and its self time (the total
less the time of the spans opened inside it); a counter's sum. Each
thread records into its own aggregates, without a lock, and
``snapshot()`` adds them up. Nothing else is kept: no list of events, no
exporter, so the memory is bounded by the number of names and threads.

Tracing is off unless ``enable()`` turns it on. The rule for what records
when:

* the per-query path (``Net.forward``'s layers, ``Net.inference_fn``'s
  entry): its spans and counters record only while tracing is on. With
  tracing off a call site reads the flag ``ON`` and nothing else;
* the set-up path (graph passes, the move to the device, the kernels'
  build and load, a new signature's first call and capture): its spans
  and counters pass ``always=True`` and always record, since they run a
  few times a process.

While tracing is on and a ``torch.profiler`` profile is recording, every
span is also a ``torch.profiler.record_function`` named ``cet:<name>``, so
it lies on the profile's host timeline beside the device's operations.
With tracing off no span is a ``record_function``: a profile of the
program then holds only what the program runs.

Span names: ``layer:<name>`` (each layer of ``Net.forward``);
``entry``, ``entry:signature``, ``entry:copy_in``, ``entry:replay`` (a
call of ``inference_fn``'s forward); ``setup:fuse``, ``setup:align``,
``setup:to_device``, ``setup:kernel_build``, ``setup:kernel_load``,
``setup:native_build``, ``setup:first_call``, ``setup:capture``,
``setup:autotune`` (each measurement of autotune's arms,
``engine/autotune``: inside ``setup:first_call`` where a forward asks for a
key first). Counters: ``entry.replays``, ``entry.eager_calls``,
``entry.captures``, ``capture.launches.<kernel>`` (each hand kernel's
launches inside the captured forwards: what their replays launch), and
the set-up counters ``autotune.measured.conv`` and ``autotune.measured.fc``
(the keys measured), ``autotune.pick.<arm>`` (the layers each arm
serves in the captured forwards) and, from ``Net.weight_align``,
``align.grouped.convs``, ``align.grouped.nnz`` and
``align.grouped.block_slots`` (the grouped convs aligned with a BSC,
their stored nonzero weights, and their GEMM view's live blocks x bk x
bn). The hand kernels' own
``calls`` / ``launches`` / ``launches_f32`` stay in their modules;
``snapshot()`` reads them.

The hand kernels are of two kinds: ``KERNELS``, the ports of the JAX
package's Pallas kernels, and ``OP_KERNELS``, kernels of ops that the JAX
package leaves to XLA (``lrn``: LRN across channels; ``maxpool``: max
pooling; ``conv_epilogue``: a dense conv's bias, residual and ReLU;
``stem_conv``: a dense conv over an image of at most 4 channels, with its
bias and ReLU).
``kernel_counts()``, and so ``snapshot()`` and the capture counters, read
both.
"""

from __future__ import annotations

import importlib
import threading
import time
from typing import Dict, List

import torch

PREFIX = "cet:"
LAYER = "layer:"
KERNELS = ("sconv_fused", "sconv_gc", "bsc_spmm")
OP_KERNELS = ("lrn", "maxpool", "conv_epilogue", "stem_conv")
KERNEL_COUNTERS = ("calls", "launches", "launches_f32")

ON = False  # read directly on the per-query path: ``if trace.ON``


class _Thread:
    """One thread's open spans and its aggregates: a span or counter
    updates only its own thread's, so recording takes no lock."""

    __slots__ = ("stack", "spans", "counters")

    def __init__(self):
        self.stack = []
        # name -> [count, total, self, max], in ns
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}


_local = threading.local()
_threads: List[_Thread] = []  # every thread that has recorded
_threads_lock = threading.Lock()


def _mine() -> _Thread:
    try:
        return _local.mine
    except AttributeError:
        mine = _local.mine = _Thread()
        with _threads_lock:
            _threads.append(mine)
        return mine


class _Off:
    """The span of a call site that does not record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "inner", "rf", "mine")

    def __init__(self, name: str):
        self.name = name
        self.inner = 0
        self.rf = None

    def __enter__(self):
        if ON and torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.mine = _mine()
        self.mine.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = self.mine.stack
        if stack and stack[-1] is self:
            stack.pop()
            if stack:
                stack[-1].inner += dt
        agg = self.mine.spans.get(self.name)
        if agg is None:
            self.mine.spans[self.name] = [1, dt, dt - self.inner, dt]
        else:
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self.inner
            if dt > agg[3]:
                agg[3] = dt
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def span(name: str, *, always: bool = False):
    """A context manager timing ``name``: a no-op unless tracing is on or
    ``always`` (a set-up span)."""
    if not (ON or always):
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1, *, always: bool = False) -> None:
    """Add ``n`` to counter ``name`` (unless tracing is off and not
    ``always``)."""
    if ON or always:
        counters = _mine().counters
        counters[name] = counters.get(name, 0) + n


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def enabled() -> bool:
    return ON


def reset() -> None:
    """Clear every span and counter aggregate (not the kernels' own
    counters: ``reset_counts`` of their modules)."""
    with _threads_lock:
        for t in _threads:
            t.spans.clear()
            t.counters.clear()


def kernel_counts() -> Dict[str, Dict[str, int]]:
    """Each hand kernel's (``KERNELS`` and ``OP_KERNELS``) ``calls`` /
    ``launches`` / ``launches_f32``, read from its module."""
    out = {}
    for k in KERNELS + OP_KERNELS:
        mod = importlib.import_module(f"caffe_escoin_tpu_torch.kernels.{k}")
        out[k] = {c: getattr(mod, c) for c in KERNEL_COUNTERS}
    return out


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s", "max_s"}},
    "counters": {name: n}, "kernels": kernel_counts()}``, over every
    thread."""
    spans: Dict[str, list] = {}
    counters: Dict[str, int] = {}
    with _threads_lock:
        threads = list(_threads)
    for t in threads:
        for name, (c, tot, own, mx) in list(t.spans.items()):
            agg = spans.setdefault(name, [0, 0, 0, 0])
            agg[0] += c
            agg[1] += tot
            agg[2] += own
            agg[3] = max(agg[3], mx)
        for name, n in list(t.counters.items()):
            counters[name] = counters.get(name, 0) + n
    return {"spans": {name: {"count": c, "total_s": tot / 1e9,
                             "self_s": own / 1e9, "max_s": mx / 1e9}
                      for name, (c, tot, own, mx) in spans.items()},
            "counters": counters, "kernels": kernel_counts()}
