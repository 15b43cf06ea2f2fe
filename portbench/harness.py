"""One run of one cell: set-up, warm-up, the measured window, the traced
readings, the check against the reference.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<file>``: the configuration (``file`` of its entry);
* ``traffic/<traffic>.json``: the mix (batch, pool of distinct batches,
  warm-up, the share of answers kept for the check, the traced stretch's
  length);
* ``metrics/<metric>.py``: a reader ``read(run) -> number or None`` for
  every metric, end-to-end and per-layer (or ``metrics/<x>.py`` for a
  metric ``<x>.<suffix>`` that has no file of its own);
* ``reference/<reference>.py``: the architecture's plain table.

A query hands the entry one batch of the pool, and ends when the
classifier's logits are on the host. A stream mix holds one query in
flight: the next is sent once the last one's logits are there. An offline
mix (one that names ``ahead_seconds``) is a backlog: queries are sent
ahead of the one the loop waits for, about ``ahead_seconds`` of the
card's work and at most ``ahead_max`` queries, each query's logits copied
behind its forward into a host slot of their own (``Ahead``), so that the
card does not wait for the host's turnaround or a short stall of it. Its
window closes so: when its time is up nothing more is sent, every query
sent is waited for, and the clock is read after that wait.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import check, counts, traced, weights
from portbench.system import PortSystem

# top-level module names the run must not have loaded (compared whole:
# the program's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "caffe_escoin_tpu")
SAMPLE_MASK = 1 << 16


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names, found under
    ``root/portbench``."""

    def __init__(self, root):
        self.root = Path(root)
        self.home = self.root / "portbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        with open(self.root / self._entry("configs", name)["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.home / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def reference(self, architecture: str):
        return _load_module(self.home / "reference" / f"{architecture}.py",
                            f"portbench_reference_{architecture}")

    def reader(self, metric: str) -> Callable:
        """``metrics/<metric>.py``, or, where there is none, the reader of
        the name before its last dot: one reader serves a quantity that
        is split by the end-to-end metric it moves (``x.offline`` and
        ``x.stream`` both read by ``x.py``)."""
        path = self.home / "metrics" / f"{metric}.py"
        if not path.is_file() and "." in metric:
            path = self.home / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
        mod = _load_module(path, "portbench_metric_" + path.stem
                           .replace(".", "_").replace("-", "_"))
        return mod.read

    def metrics_of(self, cell: str, kind: str) -> List[dict]:
        """The cell's metrics of one kind (``end_to_end`` or
        ``per_layer``): those listing it, and those listing no cells."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass
class Run:
    """What the readers read."""

    cell: dict
    config: dict
    traffic: dict
    batch: int
    setup_s: float
    queries: int = 0
    window_s: float = 0.0
    latency_s: List[float] = dataclasses.field(default_factory=list)
    device_kind: str = ""
    peak: Optional[Dict[str, float]] = None
    work: Optional[Dict[str, Dict[str, float]]] = None
    pruned: List[str] = dataclasses.field(default_factory=list)
    pruned_convs: List[str] = dataclasses.field(default_factory=list)
    stretch: Optional[traced.Stretch] = None
    layer_us: Optional[Dict[str, float]] = None
    ahead: Optional["Ahead"] = None


def process_age() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_reading(index: int, fields: str) -> str:
    """``nvidia-smi``'s reading of ``fields`` (its query names, comma
    separated) on card ``index``."""
    proc = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader", f"--id={index}"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip() if proc.returncode == 0 else "not read"


def per_second(done_s: List[float]) -> List[int]:
    """Queries completed in each whole second of a window, from the
    moments (seconds into the window, in order) at which each was seen
    on the host."""
    counts, edge = [], 1.0
    n = 0
    for t in done_s:
        while t >= edge:
            counts.append(n)
            n, edge = 0, edge + 1.0
        n += 1
    return counts


class Ahead:
    """Queries in flight beyond the one the loop waits for: query ``n``'s
    logits are copied, behind its forward on the same stream, into host
    slot ``n % depth`` (one pinned block on a card), before the next
    forward can overwrite the graph's output; ``take`` waits for the
    oldest query in flight and hands back its slot, which the next
    ``send`` may fill again."""

    def __init__(self, like: torch.Tensor, depth: int):
        self.depth = depth
        self.slots = torch.empty((depth,) + tuple(like.shape),
                                 dtype=like.dtype, pin_memory=like.is_cuda)
        self.events = ([torch.cuda.Event() for _ in range(depth)]
                       if like.is_cuda else None)
        self.pending = collections.deque()

    def full(self) -> bool:
        return len(self.pending) == self.depth

    def send(self, n: int, logits: torch.Tensor) -> None:
        i = n % self.depth
        self.slots[i].copy_(logits, non_blocking=True)
        if self.events is not None:
            self.events[i].record()
        self.pending.append(n)

    def take(self):
        """(query number, its logits on the host) of the oldest query in
        flight, once it has ended."""
        n = self.pending.popleft()
        i = n % self.depth
        if self.events is not None:
            self.events[i].synchronize()
        return n, self.slots[i]


def ahead_depth(mix: dict, query_s: float) -> int:
    """How many queries an offline mix holds in flight: ``ahead_seconds``
    of queries that take ``query_s`` each, at least 2 and at most
    ``ahead_max``."""
    want = math.ceil(mix["ahead_seconds"] / max(query_s, 1e-6))
    return max(2, min(int(mix["ahead_max"]), want))


def dispatched(system, pool, ahead: Ahead, seconds: float, keep=None):
    """The offline loop for ``seconds``: send queries over the pool, each
    once its slot is free, and wait for all that were sent once the time
    is up. Returns (queries, seconds from the first send to the end of the
    last query, the moments each query was seen on the host); ``keep(n)``
    says which queries' logits to hand back, as (pool index, logits)."""
    n_pool = pool.shape[0]
    kept, done = [], []

    def take():
        m, out = ahead.take()
        done.append(time.perf_counter() - t0)
        if keep is not None and keep(m):
            kept.append((m % n_pool, out.clone()))

    n = 0
    t0 = time.perf_counter()
    while n < n_pool or time.perf_counter() - t0 < seconds:
        if ahead.full():
            take()
        ahead.send(n, system.logits(system.issue(pool[n % n_pool])))
        n += 1
    while ahead.pending:
        take()
    return n, time.perf_counter() - t0, done, kept


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace_on: bool, device, *, make_system=None,
             clock=process_age, marks=None) -> dict:
    """One run of cell ``name``; returns the result object (the last line).
    ``make_system(cfg, table, params, device)`` builds what the window
    drives (default: the program); ``marks`` names earlier moments of the
    set-up on ``clock``, for the log."""
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    arch = bench.reference(cfg["reference"])
    batch, n_pool = mix["batch"], mix["pool_batches"]
    hwc = tuple(cfg["input_hwc"])

    t_start = clock()
    table, params, pruned = weights.make_net(cfg, arch, seed, device)
    pool = weights.images(n_pool * batch, hwc,
                          weights.generator(seed, weights.POOL, device),
                          device).view(n_pool, batch, *hwc)
    _sync(device)
    t_made = clock()
    mask = (torch.rand(SAMPLE_MASK, generator=torch.Generator().manual_seed(
        weights.stream_seed(seed, weights.SAMPLE))) < mix["check_fraction"]
            ).numpy()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    system = (make_system or PortSystem)(cfg, table, params, device)
    t_system = clock()

    # warm-up: every batch of the pool once (the first call captures the
    # graph), then the loop for warmup_seconds; an offline mix times a
    # second pass over the pool, one query at a time, for its depth
    for j in range(n_pool):
        system.query(pool[j])
    ahead = None
    if "ahead_seconds" in mix:
        _sync(device)
        t_pass = time.perf_counter()
        for j in range(n_pool):
            out = system.issue(pool[j])
            system.to_host(out)
        like = system.logits(out)
        ahead = Ahead(like, ahead_depth(
            mix, (time.perf_counter() - t_pass) / n_pool))
        dispatched(system, pool, ahead, mix["warmup_seconds"])
    else:
        t_end = time.perf_counter() + mix["warmup_seconds"]
        while time.perf_counter() < t_end:
            system.query(pool[0])
    _sync(device)
    gc.collect()
    run = Run(cell=cell, config=cfg, traffic=mix, batch=batch,
              setup_s=clock(), pruned=pruned,
              pruned_convs=[e["name"] for e in table
                            if e["type"] == "conv" and e["name"] in pruned],
              ahead=ahead)

    # the measured window
    def keep(m):
        return m < n_pool or mask[m % SAMPLE_MASK]

    if ahead is not None:
        n, run.window_s, done, kept = dispatched(system, pool, ahead,
                                                 seconds, keep)
        run.queries = n
    else:
        kept, done = [], []
        lat = run.latency_s
        n = 0
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            logits = system.query(pool[n % n_pool])
            te = time.perf_counter()
            lat.append(te - ts)
            done.append(te - t0)
            if keep(n):
                kept.append((n % n_pool, logits))
            n += 1
            if te - t0 >= seconds and n >= n_pool:
                break
        run.queries, run.window_s = n, te - t0
    card = (card_reading(device.index or 0, "clocks.sm,clocks.mem,"
                         "temperature.gpu,power.draw")
            if device.type == "cuda" else "")

    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: refused")
        raise SystemExit(3)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": int(cell["chips"]),
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}
    run.device_kind = dev_info["kind"]
    run.peak = counts.peaks(run.device_kind)
    log(f"window: {n} queries of batch {batch} in {run.window_s:.3f} s, "
        f"{ahead.depth if ahead else 1} in flight at most; "
        f"set-up {run.setup_s:.2f} s: start {t_start:.2f} "
        f"({', '.join(f'{k} {v:.2f}' for k, v in (marks or {}).items())}), "
        f"weights and images {t_made - t_start:.2f}, the program's set-up "
        f"{t_system - t_made:.2f}, first calls and warm-up "
        f"{run.setup_s - t_system:.2f}")
    log(f"queries in each second of the window: {per_second(done)}; "
        f"the card after it (clocks, temperature, power): {card}")

    breakdown = None
    if trace_on:
        breakdown = _traced(run, system, pool, n, device)
        run.work = counts.net_work(table, params, batch, hwc)
        dev_info["busy_s"] = run.stretch.busy_s if run.stretch else 0.0
        dev_info["window_s"] = run.stretch.window_s if run.stretch else 0.0

    system.close()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        dev_info["power_limit"] = card_reading(device.index or 0,
                                               "power.limit")

    numbers, per_answer = check.against_reference(table, params, pool, kept,
                                                  cfg)
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
              if k in limits}
    failed = check.failed(per_answer, limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and \
        len(checks) == len(limits)

    kind = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for m in bench.metrics_of(name, kind):
        value = bench.reader(m["name"])(run)
        if value is None:
            if kind == "end_to_end":
                raise RuntimeError(f"{name}: no reading of {m['name']}")
            log(f"{m['name']}: nothing to read, left out")
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"{name}: {m['name']} read {value}")
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result


def _traced(run: Run, system, pool, n0: int, device) -> dict:
    """The profiled stretch of the loop (as the window ran it: one query in
    flight, or ``run.ahead``'s, where the last query's ``pb:to_host`` waits
    for every query still in flight) and the layer-stepped forwards;
    returns the breakdown."""
    mix, n_pool, ahead = run.traffic, pool.shape[0], run.ahead
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rf = torch.profiler.record_function
    _sync(device)
    queries = mix["trace_queries"]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(queries):
            x = pool[(n0 + i) % n_pool]
            with rf(traced.QUERY):
                if ahead is None:
                    with rf(traced.ISSUE):
                        out = system.issue(x)
                    with rf(traced.TO_HOST):
                        system.to_host(out)
                    continue
                with rf(traced.ISSUE):
                    ahead.send(n0 + i, system.logits(system.issue(x)))
                with rf(traced.TO_HOST):
                    while ahead.full() or (i == queries - 1
                                           and ahead.pending):
                        ahead.take()
    events = prof.events()
    run.stretch = traced.read_stretch(events)
    hand = traced.hand_kernels(events)
    if run.stretch is not None:
        s = run.stretch
        log(f"stretch: {s.queries} queries in {s.window_s:.6f} s, device "
            f"busy {s.busy_s:.6f} s, {s.ops_per_query} operations a query, "
            f"idle {s.idle_by_place}")
    log(f"hand kernels in the stretch ({mix['trace_queries']} queries): "
        f"{hand}")

    spans = traced.LayerSpans()
    system.eager_forward(pool[0], spans.hook)
    spans.close()
    _sync(device)
    forwards = mix["layer_forwards"]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(forwards):
            system.eager_forward(pool[i % n_pool], spans.hook)
            spans.close()
        _sync(device)
    run.layer_us = traced.charge_layers(prof.events(), forwards)
    top = sorted(run.layer_us.items(), key=lambda kv: -kv[1])[:12]
    log(f"layer-stepped, us per forward (top 12): "
        f"{[(k, round(v, 3)) for k, v in top]}")
    if run.stretch is None:
        return {"device_ops": [], "idle_gaps": []}
    return {"device_ops": [[k, v] for k, v in run.stretch.top_ops],
            "idle_gaps": [[k, v] for k, v in run.stretch.idle_by_place]}
