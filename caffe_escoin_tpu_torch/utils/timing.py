"""Per-layer and per-category forward (and backward) timing (port of
``caffe_escoin_tpu/utils/timing.py``).

The reference's three instrumentation levels (SURVEY.md section 5):
per-layer Forward timing (`layer.hpp:438-472`), the per-category
aggregation conv / fc / data / other (`Net::GetConvTime` et al.,
`net.cpp:516-565`), and the `caffe time` per-layer report
(`tools/caffe.cpp:374-461`).

* ``time_net_layerwise`` runs each layer alone and times it, as the JAX
  function jits each layer alone.
* ``time_net_fused`` times the whole forward (what production runs).

``time_fn`` on a CUDA tensor is ``benchmark.device_time`` (CUDA-graph
replays timed by events), the counterpart of the JAX timer's device span;
on the CPU it is the host clock with a sync.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Dict, List

import numpy as np
import torch

from caffe_escoin_tpu_torch.nn.net import Net
from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight
from caffe_escoin_tpu_torch.utils.benchmark import _tensors, device_time

# layers whose forward has no backward in the JAX package's report
_NO_BACKWARD_TYPES = ("ArgMax", "Accuracy")


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median ms of ``fn(*args)``. On the card: ``device_time`` (eager
    warm-up, then CUDA-graph replays timed by events; ``fn`` must be
    capturable). Elsewhere (CPU tensors, or none: a DummyData layer): the
    host clock around each call, after ``warmup`` calls (the reference's
    CPUTimer role, `benchmark.hpp:10-48`)."""
    if any(t.is_cuda for t in _tensors(args)):
        return device_time(fn, *args, iters=iters) * 1e3
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(times))


def time_net_fused(net: Net, params, inputs, *, iters: int = 10) -> float:
    """Median ms of the whole forward (``Net.inference_fn``)."""
    return time_fn(net.inference_fn(params), inputs, iters=iters)


def _run_layer(layer, p, ins, state):
    """One layer's forward on its params, inputs and BatchNorm state."""
    if layer.has_state:
        return layer(p, ins, state[layer.spec.name])
    return layer(p, ins)


def backward_skipped(layer, p, ins) -> bool:
    """Whether the layer's row reports ``bwd_ms = 0``: decided up front, by
    the JAX function's outcome (its ``jax.grad`` over the layer's params
    and inputs raises for these, and it reports 0):

    * ArgMax and Accuracy;
    * a layer with neither params nor inputs;
    * an input that is not floating point (labels);
    * a conv whose params are an ``AlignedConvWeight`` holding a BSC or an
      ELL: in the JAX package their int32 index arrays are leaves of the
      weight. An fc's aligned weight is timed.
    """
    if layer.spec.type in _NO_BACKWARD_TYPES or not (p or ins):
        return True
    if any(not x.is_floating_point() for x in ins):
        return True
    return (layer.category == "conv" and isinstance(p, AlignedConvWeight)
            and (p.bsc is not None or p.ell_t is not None))


def _grad_leaves(p):
    """(a copy of params whose floating tensors require grad, those
    tensors). An ``AlignedConvWeight``'s dense weight, bias and BSC
    payloads become leaves; its pattern stays as it is."""
    leaves: List[torch.Tensor] = []

    def leaf(t):
        if t is None or not t.is_floating_point():
            return t
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    if isinstance(p, AlignedConvWeight):
        bsc = p.bsc
        if bsc is not None:
            bsc = dataclasses.replace(bsc, blocks=leaf(bsc.blocks))
        return dataclasses.replace(p, dense=leaf(p.dense), bias=leaf(p.bias),
                                   bsc=bsc), leaves
    return {k: leaf(v) if isinstance(v, torch.Tensor) else v
            for k, v in p.items()}, leaves


def _backward_fn(layer, p, state):
    """A callable of the layer's inputs that runs its forward and
    ``torch.autograd.grad`` of the sum of its floating outputs (in f32)
    with respect to its floating params and inputs: the JAX function's
    ``jax.grad`` over (params, inputs)."""
    gp, p_leaves = _grad_leaves(p)

    def bwd(ins):
        ins = [x.requires_grad_(True) for x in ins]
        outs = _run_layer(layer, gp, ins, state)
        total = sum(o.float().sum() for o in outs if o.is_floating_point())
        wrt = p_leaves + ins
        if not isinstance(total, torch.Tensor) or not total.requires_grad:
            # the outputs do not depend on the leaves (Threshold's step):
            # the gradient is zero, as jax.grad returns it
            return [torch.zeros_like(t) for t in wrt]
        return torch.autograd.grad(total, wrt, allow_unused=True)

    return bwd


def time_net_layerwise(net: Net, params, inputs, *, iters: int = 10,
                       backward: bool = False, state=None) -> Dict[str, Any]:
    """Per-layer timing and category buckets. Returns
    {"layers": [{name, type, category, ms, nnz, gflops, nnz_per_s}],
    "categories": {...}, "total_ms": float}; ``state`` is the BatchNorm
    state (default ``net.state0``).

    With ``backward=True`` each row gains ``bwd_ms``, the per-layer
    backward (grad with respect to the params AND the bottoms), matching
    `caffe time`'s forward/backward table (`tools/caffe.cpp:374-461`).
    The rows that report 0 are ``backward_skipped``'s; any other backward
    that raises fails the call."""
    state = net.state0 if state is None else state
    blobs = dict(inputs)
    rows: List[Dict[str, Any]] = []
    buckets = {"conv": 0.0, "fc": 0.0, "data": 0.0, "other": 0.0}
    bwd_buckets = dict(buckets)
    for layer in net.layers:
        spec = layer.spec
        ins = [blobs[b] for b in spec.bottoms]
        p = params.get(spec.share_params or spec.name, {})

        def fwd(p, ins, layer=layer):
            with torch.inference_mode():
                return _run_layer(layer, p, ins, state)

        ms = time_fn(fwd, p, ins, iters=iters)
        outs = fwd(p, ins)
        for t, o in zip(spec.tops, outs):
            blobs[t] = o
        row = {"name": spec.name, "type": spec.type,
               "category": layer.category, "ms": ms}
        if backward:
            bwd_ms = 0.0
            if not backward_skipped(layer, p, ins):
                # inference tensors cannot be saved for backward: the
                # backward runs on plain copies of the inputs
                copies = [x.clone() for x in ins]
                bwd_ms = time_fn(_backward_fn(layer, p, state), copies,
                                 iters=iters)
            row["bwd_ms"] = bwd_ms
            bwd_buckets[layer.category] += bwd_ms
        if isinstance(p, AlignedConvWeight) and ins:
            n = ins[0].shape[0]
            out_sp = int(np.prod(outs[0].shape[1:-1]))
            nnz = (p.stats.nnz if p.stats
                   else int((p.dense != 0).sum().item()))
            row["nnz"] = nnz
            row["gflops"] = 2.0 * nnz * out_sp * n / (ms * 1e-3) / 1e9
            row["nnz_per_s"] = nnz * out_sp * n / (ms * 1e-3)
        rows.append(row)
        buckets[layer.category] += ms
    result = {"layers": rows, "categories": buckets,
              "total_ms": sum(buckets.values())}
    if backward:
        result["categories_backward"] = bwd_buckets
        result["total_backward_ms"] = sum(bwd_buckets.values())
    return result


def format_report(result: Dict[str, Any]) -> str:
    """`caffe time`-style text report (tools/caffe.cpp:374-461); the same
    text as the JAX function's for the same result."""
    has_bwd = "total_backward_ms" in result
    hdr = f"{'layer':<16}{'type':<20}{'cat':<7}{'fwd ms':>9}"
    if has_bwd:
        hdr += f"{'bwd ms':>9}"
    lines = [hdr + "  extra"]
    for r in result["layers"]:
        extra = ""
        if "gflops" in r:
            extra = (f"{r['gflops']:.1f} GFLOP/s  "
                     f"{r['nnz_per_s'] / 1e9:.2f} Gnnz/s")
        line = (f"{r['name']:<16}{r['type']:<20}{r['category']:<7}"
                f"{r['ms']:>9.3f}")
        if has_bwd:
            line += f"{r.get('bwd_ms', 0.0):>9.3f}"
        lines.append(line + f"  {extra}")
    c = result["categories"]
    lines.append(
        f"[totals] conv={c['conv']:.3f}ms fc={c['fc']:.3f}ms "
        f"data={c['data']:.3f}ms other={c['other']:.3f}ms "
        f"total={result['total_ms']:.3f}ms")
    if has_bwd:
        cb = result["categories_backward"]
        lines.append(
            f"[backward] conv={cb['conv']:.3f}ms fc={cb['fc']:.3f}ms "
            f"data={cb['data']:.3f}ms other={cb['other']:.3f}ms "
            f"total={result['total_backward_ms']:.3f}ms")
    return "\n".join(lines)


def debug_info(net, params, inputs, *, state=None, log=print):
    """Per-layer blob and param mean-|x| dump, the reference's debug_info
    mode (`src/caffe/net.cpp:761-774`: "[Forward] Layer <name>, top blob
    <top> data: <asum>"). Eager per-layer execution; returns the rows."""
    blobs = dict(inputs)
    if state is None:
        state = net.state0
    rows = []
    with torch.inference_mode():
        for layer in net.layers:
            spec = layer.spec
            ins = [blobs[b] for b in spec.bottoms]
            p = params.get(spec.share_params or spec.name, {})
            if layer.has_state and spec.name not in state:
                st = {spec.name: layer.init_state(
                    [tuple(b.shape) for b in ins])}
            else:
                st = state
            outs = _run_layer(layer, p, ins, st)
            for t, o in zip(spec.tops, outs):
                blobs[t] = o
                asum = o.abs().double().mean().item()
                rows.append({"layer": spec.name, "top": t, "data": asum})
                log(f"    [Forward] Layer {spec.name}, top blob {t} "
                    f"data: {asum:.6g}")
            if isinstance(p, dict):
                for k, v in p.items():
                    if isinstance(v, torch.Tensor):
                        rows.append({"layer": spec.name, "param": k,
                                     "data": v.abs().double().mean().item()})
    return rows
