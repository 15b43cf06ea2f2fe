"""Timing of one callable on the device, and the choice of device (port of
``caffe_escoin_tpu/utils/benchmark.py``: ``device_time``,
``device_time_cycle`` and ``force_platform``), the arms of one layer
timed in turn (``device_time_arms``, the autotuner's), and the name of the
card that every number is written beside."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch

PLATFORMS = ("auto", "cpu", "cuda")


def force_platform(platform: str = "auto") -> torch.device:
    """The device an entry point runs on (the JAX function routes jax to a
    platform; torch takes the device instead): "cpu", or the card for
    "cuda" and "auto". Asking for the card where there is none raises:
    nothing falls back to the CPU. On the card f32 stays f32: TF32 is
    turned off for cuBLAS and cuDNN, so the dense and the sparse modes
    compare at one precision."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got "
                         f"{platform!r}")
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--platform {platform}: no CUDA device here; "
                           f"pass --platform cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _device_of(args) -> torch.device:
    """The device of the first tensor in ``args`` (nested lists, tuples and
    dicts searched in order)."""
    for t in _tensors(args):
        return t.device
    raise ValueError("device_time: no tensor among the arguments")


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", f"--id={index}"],
                          capture_output=True, text=True, timeout=60,
                          check=True)
    return proc.stdout.strip().splitlines()[0].strip()


def device_time(f: Callable, *args, iters: int = 20,
                arg_sets=None) -> float:
    """Median seconds per call of ``f(*args)``.

    ``arg_sets`` (a list of argument tuples, cycled across the calls; pass
    4 or more distinct ones) keeps an input from staying in the 50 MB L2
    from one call to the next, which would under-report a memory-bound
    function that a real forward runs on cold inputs.

    On a CUDA device it times the device alone, as the JAX timer reads the
    device span of one compiled program: every argument set is first run
    once eagerly (where autotune measures a key it has not seen and the
    kernels build their plans and workspaces), then ``f(*s)`` is captured
    once per set as a CUDA graph, each graph is replayed once untimed, and
    then the graphs are replayed in turn ``iters`` times, each replay
    between its own pair of CUDA events. The graphs are freed before it
    returns. ``f`` must be capturable: it reads no device value on the
    host. On a CPU tensor each eager call is timed on the host clock (for
    the tests; no device number). The device is that of the first tensor
    found in the arguments, nested lists and dicts included.
    """
    sets = list(arg_sets) if arg_sets else [args]
    return device_time_cycle([(f, s) for s in sets], iters=iters)


def device_time_cycle(pairs, *, iters: int = 20) -> float:
    """Median seconds per call over ``pairs``, a list of ``(callable,
    args)`` run in turn: ``device_time(..., arg_sets=...)`` for callables
    that each close over their own weight replica (the JAX function's
    closures, whose sparse pattern must be concrete where they are built),
    so that neither a weight nor an input stays in the L2 from one call to
    the next.

    On a CUDA device each pair is run once eagerly, captured once as its
    own CUDA graph and replayed once untimed; then the graphs are replayed
    in turn ``iters`` times, each between its own pair of CUDA events. A
    pair that cannot be captured raises: no time is read eagerly in its
    place. On CPU tensors each eager call is timed on the host clock. The
    device is that of the first tensor in the first pair's arguments."""
    return _rounds({None: list(pairs)}, iters)[None]


def device_time_arms(arms, arg_sets, *, iters: int = 20) -> dict:
    """Median seconds per call of each callable in ``arms`` (name ->
    callable) over ``arg_sets``, as ``device_time`` times one, but with
    the arms interleaved: round ``i`` runs every arm once on set ``i %
    len(arg_sets)``. A passing slowdown of the device (a clock or power
    step, another process) then falls on every arm it overlaps alike,
    where timing the arms one after another lets it inflate the one arm
    measured then and hand the pick to a slower one."""
    sets = list(arg_sets)
    return _rounds({name: [(f, s) for s in sets]
                    for name, f in arms.items()}, iters)


def _rounds(groups, iters):
    """Median seconds per call of each group of ``(callable, args)`` pairs
    (name -> pairs): every pair run once eagerly; then in round ``i`` each
    group runs its pair ``i % len(pairs)``. On a CUDA device every pair is
    captured once as its own CUDA graph and replayed once untimed, and each
    timed replay sits between its own pair of CUDA events; on CPU tensors
    each call is timed on the host clock."""
    first = next(iter(groups.values()))
    dev = _device_of(first[0][1])
    for pairs in groups.values():
        for f, a in pairs:
            f(*a)
    if dev.type != "cuda":
        times = {name: [] for name in groups}
        for i in range(iters):
            for name, pairs in groups.items():
                f, a = pairs[i % len(pairs)]
                t0 = time.perf_counter()
                f(*a)
                times[name].append(time.perf_counter() - t0)
        return {name: statistics.median(t) for name, t in times.items()}
    graphs = {}
    try:
        for name, pairs in groups.items():
            graphs[name] = []
            for f, a in pairs:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    f(*a)
                graphs[name].append(graph)
        for gs in graphs.values():  # the first launch of a graph uploads it
            for graph in gs:
                graph.replay()
        events = {name: [] for name in groups}
        for i in range(iters):
            for name, gs in graphs.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                gs[i % len(gs)].replay()
                end.record()
                events[name].append((start, end))
        torch.cuda.synchronize(dev)
        return {name: statistics.median(s.elapsed_time(e) * 1e-3
                                        for s, e in ev)
                for name, ev in events.items()}
    finally:
        del graphs
