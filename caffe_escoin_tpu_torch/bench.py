"""Benchmark: sparse-conv speedup against dense convolution on one card
(port of the repository's ``bench.py``, the JAX package's measuring
program).

    python -m caffe_escoin_tpu_torch.bench            # on the card
    python -m caffe_escoin_tpu_torch.bench --platform cpu --per-layer \\
        --smoke --batch 1                             # on the CPU

The same five modes, flags, defaults and result keys as ``bench.py``; one
JSON line on stdout, the detail on stderr, ``--jsonl FILE`` appends the
rows:

* ``--per-layer`` (and ``--smoke``): every sparse-eligible conv config of
  the model (stride 1, Cin >= 64), ordered by FLOPs, timed in three arms
  (dense f32 ``F.conv2d`` with TF32 off, dense bf16, and the sparse
  dispatcher ``ops/conv.conv2d_sconv`` in bf16), each over 4 inputs drawn
  in ``bench.py``'s order from ``default_rng(0)``, with a roofline bound
  per row from the measured stream rate. The headline is the FLOP-weighted
  conv-time speedup against dense bf16.
* ``--fc``: the model's InnerProduct shapes (m >= 128, k >= 256), dense
  f32 and bf16 matmuls against the XBSP ``spmm`` on block-pruned weights,
  4 (input, weight) replicas cycled.
* ``--e2e``: the whole forward of three nets from one init, dense f32,
  dense bf16 and sparse SCONV_PAR bf16 (conv and fc weights pruned), all
  fused; ``--calibrate`` checks the autotuned arms on the whole graph and
  ``--buckets`` splits each net's time into conv/fc/data/other.
* ``--halo``: the spatial halo path at world size 1 against the same
  convs without it.
* ``--batch-curve``: the fused sparse net's images/s at batch 1 to 64.

A bare invocation is ``--e2e --buckets`` on ResNet-50 at batch 32 with at
least 8 repeats, calibrated with a polish of 8 when autotuned.

Every time is ``utils/benchmark.device_time`` (or ``device_time_cycle``):
CUDA events around CUDA-graph replays on the card, the host clock on CPU
tensors. A forward is handed to it as the eager ``Net.inference_fn``,
which it captures itself (``inference_fn(cuda_graph=True)`` would capture
inside its capture). Each headline line names its device, the card's name
and power limit or "cpu"; a CPU run's numbers are the CPU's. Nothing falls
back: an arm or kernel that raises ends the run.

Where this module differs from ``bench.py``:

* ``--pack`` and ``--s2d`` default off (the JAX defaults: pack on, s2d on
  for GoogLeNet): on the H100 the packed layout ran 1.044-1.103x slower
  and the s2d stem fold 1.013x slower. The line says what ran (``packed``,
  ``s2d``).
* ``--per-layer`` times one layout, NHWC, once: torch has no counterpart
  of XLA's entry-layout choice that ``bench.py`` takes the better of.
* ``--weights-as-args`` raises NotImplementedError: a CUDA graph captures
  the weight tensors as they are, so there is no ``split_payloads``; the
  line keeps ``"weights_as_args": false``.
* The autotune table defaults to ``.autotune_cuda.json`` at the repository
  root (``CESCOIN_AUTOTUNE_CACHE``), not the TPU's ``.autotune_tpu.json``;
  ``CESCOIN_AUTOTUNE_LOG_HITS`` defaults to 1 as there, and
  ``CESCOIN_AUTOTUNE_FUSED`` to 1: the hand-written ``sconv_fused`` kernel
  is one of the measured arms on the card, where it won every ResNet-50
  b32 key, as the JAX package's Pallas kernel was not on the TPU. The
  three are set for the run and restored after. There is no compile
  cache.
* ``--halo`` runs the hand-written kernels: the single conv through
  ``parallel/halo.spatial_sconv2d(engine="pallas")`` (``sconv_gc``)
  against ``sconv_gc`` on the whole map, and the chain and tower on the
  kernel routes (``use_xla_sparse=False``) against the same convs in
  sequence. ``bench.py`` ran both on the XBSP arms, the TPU's executor;
  on the card they are torch ops. Its rows go to ``build/SCALING.jsonl``
  when ``--jsonl`` is empty, never to the JAX package's ``SCALING.jsonl``.
* ``spmm_tile_m`` (a TPU tile size no gate of the port reads) is gone.
* Each headline line gains one key, ``device``; the per-layer rows also
  carry ``stream_rate_tb_s``. ``--platform auto|cpu|cuda`` picks the
  device (auto: the card; without one the run exits 2).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from typing import Any, Dict, List

import numpy as np
import torch

from caffe_escoin_tpu_torch.utils.benchmark import (PLATFORMS, device_label,
                                                    device_time,
                                                    device_time_cycle,
                                                    force_platform)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# where --halo appends its rows when --jsonl is empty (build/ is not
# tracked); bench.py appended to the JAX package's record SCALING.jsonl
HALO_RECORD = os.path.join(_ROOT, "build", "SCALING.jsonl")
ENV_DEFAULTS = {
    "CESCOIN_AUTOTUNE_CACHE": os.path.join(_ROOT, ".autotune_cuda.json"),
    "CESCOIN_AUTOTUNE_LOG_HITS": "1",
    "CESCOIN_AUTOTUNE_FUSED": "1",
}
# the published HBM3 rate of one H100 SXM (NVIDIA's data sheet), against
# which the measured stream rate is reported
PUBLISHED_STREAM_RATE = 3.35e12
BLOCK = (128, 128)
N_INPUTS = 4
CURVE_BATCHES = (1, 2, 4, 8, 16, 32, 64)
HALO_SHAPES = [(56, 64, 64), (28, 128, 128), (14, 256, 256), (7, 512, 512)]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


_STREAM_RATE = None


def stream_rate(device=None) -> float:
    """Measured stream rate of the device's memory (bytes/s, read + write)
    of a 256 MB f32 ``y * 1.0001``: the denominator of the per-row roofline
    bound. Measured once per process, on ``device`` (None: the current
    card)."""
    global _STREAM_RATE
    if _STREAM_RATE is None:
        device = torch.device("cuda") if device is None else device
        x = torch.zeros((64, 1024, 1024), dtype=torch.float32, device=device)
        t = device_time(lambda y: y * 1.0001, x, iters=10)
        _STREAM_RATE = 2 * x.numel() * 4 / t
        share = (f", {_STREAM_RATE / PUBLISHED_STREAM_RATE:.0%} of the "
                 f"published {PUBLISHED_STREAM_RATE / 1e12:.2f} TB/s"
                 if x.is_cuda else "")
        log(f"measured stream rate: {_STREAM_RATE / 1e12:.2f} TB/s{share} "
            f"[{device_label(x.device)}]")
    return _STREAM_RATE


def roofline_us(n, h, w, cin, ho, wo, cout, live_blocks, bk, bn,
                dtype_bytes=2, device=None):
    """Ideal-traffic bound for one sparse conv: read the ifmap once, read
    the live weight blocks once, write the ofmap once, at the measured
    stream rate."""
    read = n * h * w * cin * dtype_bytes + live_blocks * bk * bn * dtype_bytes
    write = n * ho * wo * cout * dtype_bytes
    return (read + write) / stream_rate(device) * 1e6


def _blob_walk(model, batch):
    """(layer, bottom shapes) of the model's net at ``batch``, from the
    shape walk alone (no weights drawn)."""
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net

    builder, input_shapes = ZOO[model]
    shape = (batch,) + tuple(input_shapes["data"][1:])
    return Net(builder()).walk_shapes({"data": shape})


def conv_configs(model, batch):
    """Unique conv configs (h, w, cin, cout, k, stride, pad, group) ->
    count, from the model spec and its shape walk."""
    configs = {}
    for layer, in_shapes in _blob_walk(model, batch):
        if layer.spec.type not in ("Convolution", "ConvolutionReLU"):
            continue
        in_shape = in_shapes[0]
        p = layer.p
        key = (in_shape[1], in_shape[2], in_shape[3], p["num_output"],
               p.get("kernel", 3), p.get("stride", 1), p.get("pad", 0),
               p.get("group", 1))
        configs[key] = configs.get(key, 0) + 1
    return configs


def fc_configs(model, batch):
    """(name, k, m) of each InnerProduct layer with m >= 128 and k >= 256:
    the classifier heads stay dense."""
    fcs = []
    for layer, in_shapes in _blob_walk(model, batch):
        if layer.spec.type != "InnerProduct":
            continue
        k = int(np.prod(in_shapes[0][1:]))
        m = layer.p["num_output"]
        if m >= 128 and k >= 256:
            fcs.append((layer.spec.name, k, m))
    return fcs


def _flops_of(key, count):
    h, w, cin, cout, k, s_, p_, g_ = key
    return count * 2 * h * w * cin * cout * k * k / (s_ * s_) / g_


def per_layer_items(args):
    """(items, eligible): the sparse-eligible conv configs (stride 1, Cin
    >= 64) with their counts, the measured ones first by FLOPs (2 with
    ``--smoke``, ``--layers`` N)."""
    configs = conv_configs(args.model, args.batch)
    eligible = {k: c for k, c in configs.items()
                if k[5] == 1 and k[2] >= 64}
    log(f"conv configs: {len(configs)} unique; eligible {len(eligible)}, "
        f"dense-in-both {len(configs) - len(eligible)}")
    items = sorted(eligible.items(), key=lambda kv: -_flops_of(*kv))
    if args.smoke:
        items = items[:2]
    elif args.layers:
        items = items[: args.layers]
    return items, eligible


def _sparse_policy(args, **kw):
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy

    return ExecutionPolicy(block_shape=BLOCK, compute_dtype=torch.bfloat16,
                           cast_back=False, **kw)


def per_layer_cases(args, items):
    """Each measured config with its data, drawn as ``bench.py`` draws
    them: ``default_rng(0)``, then per config 4 inputs and the weight.
    Yields (key, count, inputs, pruned weight, aligned weight) in numpy
    and on the host."""
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    rng = np.random.default_rng(0)
    policy = _sparse_policy(args, autotune=args.autotune,
                            xbsp_arm=args.xbsp_arm)
    block = BLOCK if args.granularity == "block" else None
    for (h, w, cin, cout, k, s, p, g), count in items:
        xs = [rng.standard_normal((args.batch, h, w, cin)).astype(np.float32)
              * 0.1 for _ in range(N_INPUTS)]
        wt = rng.standard_normal((k, k, cin // g, cout)).astype(
            np.float32) * 0.05
        wp = prune_conv_weight(wt, args.sparsity, block)
        aligned = weight_align(wp, None, groups=g, policy=policy)
        yield (h, w, cin, cout, k, s, p, g), count, xs, wp, aligned


def run_per_layer(args, device):
    import torch.nn.functional as F

    from caffe_escoin_tpu_torch.ops import conv as conv_ops

    items, eligible = per_layer_items(args)
    cover = sum(_flops_of(*kv) for kv in items) / max(
        1, sum(_flops_of(*kv) for kv in eligible.items()))
    log(f"measuring {len(items)} configs covering {cover:.0%} of eligible "
        f"conv FLOPs ({args.granularity} pruning @ {args.sparsity:.0%})")
    policy = _sparse_policy(args, autotune=args.autotune,
                            xbsp_arm=args.xbsp_arm)
    rows = []
    tot = {"f32": 0.0, "bf16": 0.0, "sp": 0.0}
    total_nnz_work = 0.0
    for key, count, xnp, wp, aligned in per_layer_cases(args, items):
        h, w, cin, cout, k, s, p, g = key
        if aligned.bsc is None:
            log(f"  {h}x{w} {cin}->{cout} k{k}: below sparse threshold, "
                f"dense in both — skipping")
            continue
        xs = [torch.from_numpy(x).to(device) for x in xnp]
        xbs_ = [x.bfloat16() for x in xs]
        al = aligned.to(device, torch.bfloat16)
        # NCHW views of NHWC (channels_last) tensors and OIHW weights
        wj = torch.from_numpy(wp).to(device).permute(3, 2, 0, 1)
        wb = wj.bfloat16()

        def dense(y, wt):
            return F.conv2d(y.permute(0, 3, 1, 2), wt, stride=s, padding=p,
                            groups=g).permute(0, 2, 3, 1)

        def sparse(y):
            return conv_ops.conv2d_sconv(y, al, stride=(s, s),
                                         padding=(p, p), dilation=(1, 1),
                                         relu=False, policy=policy,
                                         batch_parallel=True)

        with torch.inference_mode():
            err = float((sparse(xbs_[0]).float() - dense(xs[0], wj)
                         ).abs().max())
            reps = max(args.repeats, 8)
            tf = device_time(lambda y: dense(y, wj), xs[0], iters=reps,
                             arg_sets=[(x,) for x in xs])
            tb = device_time(lambda y: dense(y, wb), xbs_[0], iters=reps,
                             arg_sets=[(x,) for x in xbs_])
            ts = device_time(sparse, xbs_[0], iters=reps,
                             arg_sets=[(x,) for x in xbs_])
        flops = 2 * args.batch * h * w * cin * cout * k * k / (s * s)
        nnz = aligned.stats.nnz
        out_pix = args.batch * (h // s) * (w // s)
        bk_, bn_ = aligned.bsc.block_shape
        live = int(aligned.bsc.pattern()[1].sum())
        bound = roofline_us(args.batch, h, w, cin, h // s, w // s, cout,
                            live, bk_, bn_, device=device)
        variant = ("nopad" if os.environ.get("CESCOIN_XBSP_NOPAD")
                   else None)
        rows.append(dict(h=h, w=w, cin=cin, cout=cout, k=k, count=count,
                         **({"xbsp_arm": args.xbsp_arm}
                            if args.xbsp_arm != "auto" else {}),
                         **({"variant": variant} if variant else {}),
                         t_dense_f32_us=round(tf * 1e6, 2),
                         t_dense_bf16_us=round(tb * 1e6, 2),
                         t_sparse_us=round(ts * 1e6, 2),
                         speedup_vs_f32=round(tf / ts, 3),
                         speedup_vs_bf16=round(tb / ts, 3),
                         bound_us=round(bound, 2),
                         x_of_bound=round(ts * 1e6 / bound, 2) if bound else 0,
                         err=err, sparsity=args.sparsity,
                         granularity=args.granularity, model=args.model,
                         batch=args.batch, flops=flops, nnz=nnz,
                         stream_rate_tb_s=round(stream_rate() / 1e12, 4)))
        tot["f32"] += tf * count
        tot["bf16"] += tb * count
        tot["sp"] += ts * count
        total_nnz_work += nnz * out_pix * count
        log(f"  {h:3d}x{w:3d} {cin:4d}->{cout:4d} k{k} x{count}: "
            f"f32 {tf*1e6:7.1f}us bf16 {tb*1e6:7.1f}us "
            f"sparse {ts*1e6:7.1f}us  vs_f32 {tf/ts:5.2f}x "
            f"vs_bf16 {tb/ts:5.2f}x bound {bound:6.1f}us "
            f"({ts*1e6/max(bound,1e-9):4.2f}x of SoL) err {err:.1e}")

    gran = "" if args.granularity == "block" else "_unstructured"
    metric = (f"{args.model}_sparse_conv_speedup_"
              f"{int(round(args.sparsity * 100))}{gran}")
    if not rows or tot["sp"] <= 0:
        return _emit({"metric": metric, "value": 0.0, "unit": "x",
                      "vs_baseline": 0.0}, device)
    _append(args.jsonl, rows)
    sp_bf16 = tot["bf16"] / tot["sp"]
    sp_f32 = tot["f32"] / tot["sp"]
    gnnz_s = total_nnz_work / tot["sp"] / 1e9
    log(f"TOTAL: f32 {tot['f32']*1e3:.2f}ms bf16 {tot['bf16']*1e3:.2f}ms "
        f"sparse {tot['sp']*1e3:.2f}ms -> vs_f32 {sp_f32:.2f}x "
        f"vs_bf16 {sp_bf16:.2f}x ({gnnz_s:.1f} Gnnz/s)")
    return _emit({
        "metric": metric,
        "value": round(sp_bf16, 3),
        "unit": "x_vs_dense_bf16_xla_conv",
        "batch": args.batch,
        "vs_baseline": round(sp_bf16 / 2.0, 3),
        "speedup_vs_dense_f32": round(sp_f32, 3),
        "gnnz_per_s": round(gnnz_s, 1),
        "autotune": bool(args.autotune),
    }, device, args.jsonl)


def run_fc(args, device):
    """Sparse FC microbench: the model's InnerProduct shapes, dense f32 and
    bf16 matmuls against the XBSP SpMM on block-pruned weights."""
    from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
    from caffe_escoin_tpu_torch.sparse import dense_to_bsc
    from caffe_escoin_tpu_torch.utils.pruning import prune_blocks

    fcs = fc_configs(args.model, args.batch)
    log(f"fc configs: {fcs}")
    rng = np.random.default_rng(0)
    rows = []
    tot = {"f32": 0.0, "bf16": 0.0, "sp": 0.0}
    for name, k, m in fcs:
        # 4 (input, weight) replicas, cycled while timing, so that no
        # weight stays in the L2 between calls, as in a real forward
        wvars = [prune_blocks(
            rng.standard_normal((k, m)).astype(np.float32) * 0.02,
            args.sparsity, BLOCK) for _ in range(N_INPUTS)]
        bscs = [dense_to_bsc(wv, BLOCK).to(device, torch.bfloat16)
                for wv in wvars]
        wjs = [torch.from_numpy(wv).to(device) for wv in wvars]
        del wvars
        wbs = [w_.bfloat16() for w_ in wjs]
        xvars = [torch.from_numpy(
            rng.standard_normal((args.batch, k)).astype(np.float32) * 0.1
        ).to(device) for _ in range(N_INPUTS)]
        xbvars = [xv.bfloat16() for xv in xvars]
        with torch.inference_mode():
            err = float((xbs.spmm(xbvars[0], bscs[0]).float()
                         - xvars[0] @ wjs[0]).abs().max())
            reps = max(args.repeats, 8)
            tf = device_time(torch.matmul, xvars[0], wjs[0], iters=reps,
                             arg_sets=list(zip(xvars, wjs)))
            tb = device_time(torch.matmul, xbvars[0], wbs[0], iters=reps,
                             arg_sets=list(zip(xbvars, wbs)))
            ts = device_time_cycle(
                [(lambda y, _b=b: xbs.spmm(y, _b), (xv,))
                 for b, xv in zip(bscs, xbvars)], iters=reps)
        del wjs, wbs, bscs
        tot["f32"] += tf
        tot["bf16"] += tb
        tot["sp"] += ts
        rows.append(dict(layer=name, k=k, m=m, model=args.model,
                         batch=args.batch, sparsity=args.sparsity,
                         t_dense_f32_us=round(tf * 1e6, 2),
                         t_dense_bf16_us=round(tb * 1e6, 2),
                         t_sparse_us=round(ts * 1e6, 2),
                         speedup_vs_f32=round(tf / ts, 3),
                         speedup_vs_bf16=round(tb / ts, 3), err=err,
                         kind="fc"))
        log(f"  {name} {k}x{m}: f32 {tf*1e6:7.1f}us bf16 {tb*1e6:7.1f}us "
            f"sparse {ts*1e6:7.1f}us vs_f32 {tf/ts:5.2f}x "
            f"vs_bf16 {tb/ts:5.2f}x err {err:.1e}")
    _append(args.jsonl, rows)
    if not rows or tot["sp"] <= 0:
        return _emit({"metric": f"{args.model}_sparse_fc", "value": 0.0,
                      "unit": "x", "vs_baseline": 0.0}, device)
    return _emit({
        "metric": (f"{args.model}_sparse_fc_speedup_"
                   f"{int(round(args.sparsity * 100))}"),
        "value": round(tot["bf16"] / tot["sp"], 3),
        "unit": "x_vs_dense_bf16_matmul",
        "batch": args.batch,
        "vs_baseline": round(tot["bf16"] / tot["sp"] / 2.0, 3),
        "speedup_vs_dense_f32": round(tot["f32"] / tot["sp"], 3),
    }, device, args.jsonl)


@dataclasses.dataclass
class E2E:
    """The three nets of ``run_e2e`` and what they run on: params on the
    device (dense f32, dense bf16, the sparse arm's aligned weights in
    bf16), the 4 inputs and the shapes; on the host, the pruned params
    before the graph passes (``pruned``, with the names of the layers
    pruned) and after them (``pruned_s``, the sparse net's weights before
    alignment)."""

    net_d: Any
    params_d: Dict[str, Any]
    net_db: Any
    params_db: Dict[str, Any]
    net_s: Any
    aligned: Dict[str, Any]
    xs: List[torch.Tensor]
    shapes: Dict[str, tuple]
    pruned: Dict[str, Any]
    pruned_names: List[str]
    pruned_s: Dict[str, Any]


def prepare_e2e(args, device, *, specs=None, shapes=None, params=None,
                state=None) -> E2E:
    """``bench.py``'s e2e preparation: three nets from one init (seed 0 of
    the port's generator, or ``params`` and ``state`` when given, e.g.
    carried from the JAX package), conv weights with KH*KW*Cin >= 32 and
    every InnerProduct pruned (blocks, or element-wise for
    ``--granularity unstructured``), ``fuse_inference`` on all three, the
    stem s2d fold and the packed layout on the sparse arm by the flags,
    then ``weight_align``; the 4 inputs from ``default_rng(0)``. ``specs``
    and ``shapes`` default to the model's at ``args.batch``."""
    from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
    from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,
                                                      prune_conv_weight,
                                                      prune_magnitude)

    builder, input_shapes = ZOO[args.model]
    if specs is None:
        specs = builder()
    if shapes is None:
        shapes = {"data": (args.batch,) + tuple(input_shapes["data"][1:])}
    block = BLOCK if args.granularity == "block" else None
    pol_sparse = _sparse_policy(args, conv_mode=ConvMode.SCONV_PAR,
                                autotune=args.autotune,
                                xbsp_arm=args.xbsp_arm)
    net_d = Net(specs, policy=ExecutionPolicy(), phase="test")
    net_db = Net(specs, policy=ExecutionPolicy(
        compute_dtype=torch.bfloat16, cast_back=False), phase="test")
    net_s = Net(specs, policy=pol_sparse, phase="test")
    # one init: the three nets share the weights
    drawn = net_d.init(torch.Generator().manual_seed(0), shapes)
    params = drawn if params is None else params
    state = net_d.state0 if state is None else state

    # prune conv and fc weights (the fc bucket is first-class in the
    # reference's report, tools/caffe.cpp:338-367)
    pruned = dict(params)
    names = []
    for layer in net_s.layers:
        n = layer.spec.name
        if n not in pruned:
            continue
        q = dict(pruned[n])
        if layer.spec.type in ("Convolution", "ConvolutionReLU"):
            w = q["w"].numpy()
            if w.shape[0] * w.shape[1] * w.shape[2] < 32:
                continue  # a 3-channel 1x1 or 3x3 stem: dense in both
            wp = prune_conv_weight(w, args.sparsity, block)
        elif layer.spec.type == "InnerProduct":
            w = q["w"].numpy()
            wp = (prune_magnitude(w, args.sparsity) if block is None
                  else prune_blocks(w, args.sparsity, block))
        else:
            continue
        q["w"] = torch.from_numpy(wp)
        pruned[n] = q
        names.append(n)

    # inference fusion on all three arms, so the sparse speedup isolates
    # sparsity; the s2d fold and the packed layout on the sparse arm only
    if args.fuse:
        net_d, params_d = fuse_inference(net_d, params, state=state)
        net_db, params_db = fuse_inference(net_db, params, state=state)
        net_s.blob_shapes = dict(net_d.blob_shapes)  # same graph/shapes
        net_s, pruned_s = fuse_inference(net_s, pruned, state=state)
        log(f"fusion: {len(specs)} -> {len(net_s.layers)} layers")
        if args.s2d:
            from caffe_escoin_tpu_torch.nn.fuse import fold_stem_s2d

            net_s, pruned_s = fold_stem_s2d(net_s, pruned_s)
            log("stem s2d fold applied (sparse arm)")
        if args.pack:
            from caffe_escoin_tpu_torch.nn.fuse import pack_narrow_chains

            net_s = pack_narrow_chains(net_s)
            if getattr(net_s, "packed_blobs", None):
                log(f"packed {len(net_s.packed_blobs)} blobs (W-pair "
                    f"layout): {sorted(net_s.packed_blobs)[:6]}...")
    else:
        params_d, params_db, pruned_s = params, params, pruned
    aligned = net_s.weight_align(pruned_s)
    for net in (net_d, net_db, net_s):  # BatchNorm that did not fold
        net.state0 = params_to(net.state0, device)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(shapes["data"]).astype(
        np.float32) * 0.1).to(device) for _ in range(N_INPUTS)]
    return E2E(net_d=net_d, params_d=params_to(params_d, device),
               net_db=net_db,
               params_db=params_to(params_db, device, torch.bfloat16),
               net_s=net_s,
               aligned=params_to(aligned, device, torch.bfloat16),
               xs=xs, shapes=shapes, pruned=pruned, pruned_names=names,
               pruned_s=pruned_s)


def _first(out):
    return out[next(iter(out))]


def _forward_time(fwd, xs, reps):
    """device_time of ``fwd`` over the inputs ``xs`` (each forward as a
    CUDA graph on the card)."""
    return device_time(lambda y: _first(fwd({"data": y})), xs[0],
                       iters=reps, arg_sets=[(x,) for x in xs])


def run_e2e(args, device):
    from caffe_escoin_tpu_torch.engine import autotune

    e = prepare_e2e(args, device)
    reps = max(args.repeats, 8)
    calib_report = None
    if args.calibrate and args.autotune:
        # graph-level check of the per-layer autotuned picks: the composed
        # forward over candidate arm assignments, the all-dense one as the
        # never-lose floor; each time_fn captures anew (the trials change
        # the routes)
        def _time_sparse():
            with autotune.net_scope(args.model):
                return _forward_time(e.net_s.inference_fn(e.aligned), e.xs,
                                     reps)

        calib_report = autotune.calibrate_graph(
            _time_sparse, polish=args.calibrate_polish, net_tag=args.model,
            log=log)
    td = _forward_time(e.net_d.inference_fn(e.params_d), e.xs, reps)
    tdb = _forward_time(e.net_db.inference_fn(e.params_db), e.xs, reps)
    # the sparse forward consults the autotune cache: serve this net's
    # calibrated (net-scoped) assignment when one was persisted
    with autotune.net_scope(args.model):
        ts = _forward_time(e.net_s.inference_fn(e.aligned), e.xs, reps)
    log(f"e2e {args.model} batch {args.batch}: dense-f32 {td*1e3:.2f}ms "
        f"dense-bf16 {tdb*1e3:.2f}ms sparse {ts*1e3:.2f}ms "
        f"-> vs_f32 {td/ts:.2f}x vs_bf16 {tdb/ts:.2f}x "
        f"[{device_label(device)}]")

    # conv/fc/other bucket split (the reference's net.cpp:516-565): each
    # layer timed alone; the layerwise sum is reported beside the e2e
    # total, and the buckets as shares of it
    buckets = {}
    if args.buckets:
        from caffe_escoin_tpu_torch.utils.timing import time_net_layerwise

        x = {"data": e.xs[0]}
        rep_s = time_net_layerwise(e.net_s, e.aligned, x, iters=3)
        rep_d = time_net_layerwise(e.net_d, e.params_d, x, iters=3)
        for name, rep, e2e_ms in (("sparse", rep_s, ts * 1e3),
                                  ("dense", rep_d, td * 1e3)):
            cats = rep["categories"]
            lsum = max(sum(cats.values()), 1e-9)
            buckets[name] = {
                "layerwise_ms": {k: round(v, 3) for k, v in cats.items()},
                "layerwise_sum_ms": round(lsum, 3),
                "e2e_ms": round(e2e_ms, 3),
                "of_e2e_ms": {k: round(v / lsum * e2e_ms, 3)
                              for k, v in cats.items()},
            }
            log(f"  {name} buckets: {buckets[name]}")

    gran = "" if args.granularity == "block" else "_unstructured"
    result = {
        "metric": (f"{args.model}_e2e_speedup_"
                   f"{int(round(args.sparsity * 100))}{gran}"),
        "value": round(tdb / ts, 3),
        "unit": "x_vs_dense_bf16_e2e",
        "batch": args.batch,
        "vs_baseline": round((tdb / ts) / 2.0, 3),
        "speedup_vs_dense_f32": round(td / ts, 3),
        "t_dense_f32_ms": round(td * 1e3, 3),
        "t_dense_bf16_ms": round(tdb * 1e3, 3),
        "t_sparse_ms": round(ts * 1e3, 3),
        "fused": bool(args.fuse),
        "autotune": bool(args.autotune),
        "packed": bool(args.pack and args.fuse),
        "s2d": bool(args.fuse and args.s2d),
        "weights_as_args": False,
    }
    if args.xbsp_arm != "auto":
        # a forced arm's row must be told apart from headline rows
        result["xbsp_arm"] = args.xbsp_arm
    if calib_report is not None:
        result["calibrated"] = True
        result["calibration"] = {
            k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in calib_report.items() if k != "arms"}
    if buckets:
        result["buckets"] = buckets
    return _emit(result, device, args.jsonl)


def run_halo(args, device):
    """Halo-path overhead at world size 1: the spatial path of
    parallel/halo.py on a (data 1, model 1) mesh against the same convs
    without it, on the hand-written kernels."""
    import torch.distributed as dist

    from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib

    made = not dist.is_initialized()
    mesh_lib.multihost_init(platform=device.type)
    try:
        rows = _halo_rows(args, device, mesh_lib.make_mesh(data=1, model=1))
    finally:
        if made:
            dist.destroy_process_group()

    # headline: over the shapes, the worst of each map size's best
    # execution (per-layer calls, the tower or the one-entry chain)
    best_by_shape = {}
    for r in rows:
        key = (r["h"], r["cin"])
        ov = r.get("overhead_perlayer", r["overhead"])
        ov = min(ov, r["overhead"], r.get("overhead_chain", ov))
        cur = best_by_shape.get(key)
        best_by_shape[key] = ov if cur is None else min(cur, ov)
    worst = max(best_by_shape.values())
    out = args.jsonl or HALO_RECORD
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    _append(out, rows)
    return _emit({"metric": "halo_overhead_1dev_worst",
                  "value": round(worst, 4), "unit": "fractional_overhead",
                  "vs_baseline": 1.0 if worst < 0.10 else 0.0,
                  "rows": len(rows)}, device, out)


def _halo_rows(args, device, mesh):
    """``bench.py``'s halo rows: each shape's single conv, then each
    Cin == Cout shape's chain of three, every weight and input drawn from
    ``default_rng(0)`` in ``bench.py``'s order."""
    from caffe_escoin_tpu_torch.kernels import sconv_gc
    from caffe_escoin_tpu_torch.ops import conv as conv_ops
    from caffe_escoin_tpu_torch.parallel import halo
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    pol = _sparse_policy(args, use_xla_sparse=False)
    rng = np.random.default_rng(0)
    reps = max(args.repeats, 8)

    def inputs(hw, cin):
        return [torch.from_numpy(rng.standard_normal(
            (args.batch, hw, hw, cin)).astype(np.float32) * 0.1).to(
                device).bfloat16() for _ in range(N_INPUTS)]

    def timed(fn, xs):
        return device_time(fn, xs[0], iters=reps,
                           arg_sets=[(x,) for x in xs])

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    rows = []
    with torch.inference_mode():
        for hw, cin, cout in HALO_SHAPES:
            w = prune_conv_weight(
                rng.standard_normal((3, 3, cin, cout)).astype(np.float32),
                args.sparsity, BLOCK)
            al = weight_align(w, None, policy=pol).to(device, torch.bfloat16)
            xs = inputs(hw, cin)

            def plain(y, al=al):
                return sconv_gc.sconv(y, al, padding=(1, 1), relu=False,
                                      mxu_dtype=pol.mxu_dtype)

            def haloed(y, al=al):
                return halo.spatial_sconv2d(y, al, mesh=mesh, padding=(1, 1),
                                            policy=pol, engine="pallas")

            err = max_err(plain(xs[0]), haloed(xs[0]))
            tp, th = timed(plain, xs), timed(haloed, xs)
            over = th / tp - 1.0
            log(f"halo 1-dev {hw}x{hw} {cin}->{cout}: plain {tp*1e6:7.1f}us "
                f"halo {th*1e6:7.1f}us overhead {over*100:+.1f}% "
                f"err {err:.1e}")
            rows.append({"metric": "halo_overhead_1dev", "h": hw, "w": hw,
                         "cin": cin, "cout": cout, "batch": args.batch,
                         "sparsity": args.sparsity,
                         "t_plain_us": round(tp * 1e6, 2),
                         "t_halo_us": round(th * 1e6, 2),
                         "overhead": round(over, 4), "err": err,
                         "backend": device.type})
        # a 3x k3 chain: per-layer halo calls, the tower (one exchange of
        # the summed halo) and the one-entry chain (one exchange per
        # layer) against the three convs in sequence
        for hw, cin, cout in HALO_SHAPES:
            if cin != cout:
                continue
            als = [weight_align(prune_conv_weight(
                rng.standard_normal((3, 3, cin, cout)).astype(np.float32),
                args.sparsity, BLOCK), None, policy=pol).to(
                    device, torch.bfloat16) for _ in range(3)]
            xs = inputs(hw, cin)

            def chain_plain(y, als=als):
                for a in als:
                    y = conv_ops.conv2d_sconv(
                        y, a, stride=(1, 1), padding=(1, 1), dilation=(1, 1),
                        policy=pol, relu=True, batch_parallel=True)
                return y

            def chain_perlayer(y, als=als):
                for a in als:
                    y = halo.spatial_sconv2d(y, a, mesh=mesh, padding=(1, 1),
                                             policy=pol, relu=True)
                return y

            def chain_tower(y, als=als):
                return halo.spatial_sconv_tower(y, als, mesh=mesh,
                                                policy=pol, relu=True)

            def chain_one(y, als=als):
                return halo.spatial_sconv_chain(y, als, mesh=mesh,
                                                policy=pol, relu=True)

            ref = chain_plain(xs[0])
            err = max_err(ref, chain_tower(xs[0]))
            err_c = max_err(ref, chain_one(xs[0]))
            tp, tl = timed(chain_plain, xs), timed(chain_perlayer, xs)
            tt, tc = timed(chain_tower, xs), timed(chain_one, xs)
            log(f"halo tower {hw}x{hw} {cin}: plain {tp*1e6:7.1f}us "
                f"per-layer {tl*1e6:7.1f}us ({tl/tp-1:+.1%}) tower "
                f"{tt*1e6:7.1f}us ({tt/tp-1:+.1%}) one-entry "
                f"{tc*1e6:7.1f}us ({tc/tp-1:+.1%}) err {err:.1e}/{err_c:.1e}")
            rows.append({"metric": "halo_tower_overhead_1dev", "h": hw,
                         "w": hw, "cin": cin, "layers": 3,
                         "batch": args.batch, "sparsity": args.sparsity,
                         "t_plain_us": round(tp * 1e6, 2),
                         "t_perlayer_us": round(tl * 1e6, 2),
                         "t_tower_us": round(tt * 1e6, 2),
                         "t_chain_us": round(tc * 1e6, 2),
                         "overhead_perlayer": round(tl / tp - 1.0, 4),
                         "overhead_chain": round(tc / tp - 1.0, 4),
                         "overhead": round(tt / tp - 1.0, 4), "err": err,
                         "backend": device.type})
    return rows


def run_batch_curve(args, device):
    """Throughput against batch size for the fused sparse net on one
    device. The weights (seed 0) do not depend on the batch, so they are
    drawn, pruned, fused and aligned once."""
    from caffe_escoin_tpu_torch.engine.context import ConvMode
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    builder, input_shapes = ZOO[args.model]
    pol = _sparse_policy(args, conv_mode=ConvMode.SCONV_PAR,
                         autotune=args.autotune)
    net = Net(builder(), policy=pol, phase="test")

    def shapes_of(batch):
        return {"data": (batch,) + tuple(input_shapes["data"][1:])}

    params = net.init(torch.Generator().manual_seed(0),
                      shapes_of(CURVE_BATCHES[0]))
    pruned = dict(params)
    for layer in net.layers:
        n = layer.spec.name
        if n not in pruned or layer.spec.type not in (
                "Convolution", "ConvolutionReLU"):
            continue
        w = pruned[n]["w"].numpy()
        if w.shape[0] * w.shape[1] * w.shape[2] < 32:
            continue
        pruned[n] = dict(pruned[n], w=torch.from_numpy(
            prune_conv_weight(w, args.sparsity, BLOCK)))
    fnet, fparams = fuse_inference(net, pruned, state=net.state0)
    if args.pack:
        from caffe_escoin_tpu_torch.nn.fuse import pack_narrow_chains

        fnet = pack_narrow_chains(fnet)
    fwd = fnet.inference_fn(params_to(fnet.weight_align(fparams), device,
                                      torch.bfloat16))
    rows = []
    best = 0.0
    for batch in CURVE_BATCHES:
        rx = np.random.default_rng(0)
        xs = [torch.from_numpy(rx.standard_normal(shapes_of(batch)["data"])
                               .astype(np.float32) * 0.1).to(device)
              for _ in range(N_INPUTS)]
        t = _forward_time(fwd, xs, max(args.repeats, 8))
        ips = batch / t
        best = max(best, ips)
        rows.append(dict(kind="batch_curve", model=args.model, batch=batch,
                         t_ms=round(t * 1e3, 3),
                         images_per_s=round(ips, 1),
                         sparsity=args.sparsity))
        log(f"  batch {batch:3d}: {t*1e3:7.3f} ms  {ips:9.1f} img/s")
    _append(args.jsonl, rows)
    sat = rows[-1]["images_per_s"] / best if best else 0.0
    return _emit({
        "metric": f"{args.model}_sparse_batch_curve_peak",
        "value": round(best, 1), "unit": "images_per_s",
        "vs_baseline": round(sat, 3),
        "rows": [[r["batch"], r["images_per_s"]] for r in rows],
    }, device)


def _append(path, rows):
    if path and rows:
        with open(path, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


def _emit(headline, device, jsonl=""):
    """The headline with its ``device``: appended to ``jsonl`` when given,
    printed as the JSON line on stdout, and returned."""
    headline["device"] = device_label(device)
    _append(jsonl, [headline])
    print(json.dumps(headline))
    return headline


def parse_args(argv=None):
    """``bench.py``'s flags and defaults, with this module's deviations;
    a bare invocation gets the headline run's settings."""
    ap = argparse.ArgumentParser(
        prog="python -m caffe_escoin_tpu_torch.bench",
        description="Sparse against dense convolution on one card (the "
                    "port of bench.py); see the module docstring.")
    ap.add_argument("--smoke", action="store_true", help="2 shapes, quick")
    ap.add_argument("--model", default="resnet50",
                    help="any ZOO model (resnet50 is the headline config)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--layers", type=int, default=0,
                    help="measure top-N configs by FLOP share (0 = all)")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--granularity", choices=["block", "unstructured"],
                    default="block")
    ap.add_argument("--e2e", action="store_true",
                    help="whole-net Net.inference_fn timing instead of "
                         "per-layer conv configs")
    ap.add_argument("--fc", action="store_true",
                    help="sparse FC microbench on the model's InnerProduct "
                         "shapes")
    ap.add_argument("--batch-curve", action="store_true",
                    help="sparse throughput against batch size")
    ap.add_argument("--halo", action="store_true",
                    help="halo-path overhead at world size 1 (rows to "
                         "build/SCALING.jsonl unless --jsonl)")
    ap.add_argument("--buckets", action="store_true",
                    help="with --e2e: also report conv/fc/other bucket split")
    ap.add_argument("--fuse", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="with --e2e: inference graph fusion (BN/Scale fold, "
                         "ReLU/residual epilogues) on all arms")
    ap.add_argument("--weights-as-args", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="not implemented: a CUDA graph captures the weight "
                         "tensors as they are")
    ap.add_argument("--pack", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="W-pair packed layout for narrow-channel towers "
                         "(sparse arm; nn/fuse.pack_narrow_chains); off by "
                         "default, slower on the H100")
    ap.add_argument("--s2d", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="space-to-depth stem-conv fold (sparse arm; "
                         "nn/fuse.fold_stem_s2d); off by default, slower on "
                         "the H100")
    ap.add_argument("--autotune", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="measured per-shape executor selection with a "
                         "dense never-lose floor (engine/autotune.py)")
    ap.add_argument("--jsonl", default="",
                    help="append per-layer measurement rows to this file")
    ap.add_argument("--xbsp-arm", default="auto",
                    choices=["auto", "unroll", "gathered", "gathered_cols",
                             "fused", "dense"],
                    help="force one XBSP executor arm in the sparse policy "
                         "(diagnostic)")
    ap.add_argument("--calibrate-polish", type=int, default=0,
                    help="with --calibrate: up to N trials of other arms on "
                         "the highest-traffic keys")
    ap.add_argument("--calibrate", action="store_true",
                    help="with --e2e --autotune: graph-level arm "
                         "calibration before measuring; winners persist to "
                         "the autotune cache")
    ap.add_argument("--per-layer", action="store_true",
                    help="per-layer conv-config measurement")
    ap.add_argument("--platform", default="auto", choices=PLATFORMS,
                    help="auto: the card (exit 2 without one); cpu: the "
                         "host, for tests")
    args = ap.parse_args(argv)
    # no-flag default: the headline measurement, the fused and autotuned
    # whole-net e2e on ResNet-50 at the reference's test batch 32
    # (models/resnet/test_sconv.prototxt:40), calibrated with a bounded
    # polish
    if not (args.e2e or args.fc or args.batch_curve or args.per_layer
            or args.smoke or args.halo):
        args.e2e = True
        args.buckets = True
        if args.batch == ap.get_default("batch"):
            args.batch = 32
        args.repeats = max(args.repeats, 8)
        if args.autotune and not args.calibrate:
            args.calibrate = True
            args.calibrate_polish = max(args.calibrate_polish, 8)
    return args


@contextlib.contextmanager
def _env_defaults():
    """``ENV_DEFAULTS`` where the environment sets nothing, for the run;
    restored after."""
    added = [k for k in ENV_DEFAULTS if k not in os.environ]
    os.environ.update({k: ENV_DEFAULTS[k] for k in added})
    try:
        yield
    finally:
        for k in added:
            os.environ.pop(k, None)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.weights_as_args:
        raise NotImplementedError(
            "--weights-as-args: the port captures each forward as a CUDA "
            "graph over the weight tensors as they are; there is no "
            "split_payloads")
    try:
        device = force_platform(args.platform)
    except RuntimeError as e:
        log(f"bench: {e}")
        return 2
    log(f"backend: {device.type}, device: {device_label(device)}, torch "
        f"{torch.__version__}")
    with _env_defaults():
        if args.e2e:
            run_e2e(args, device)
        elif args.fc:
            run_fc(args, device)
        elif args.halo:
            run_halo(args, device)
        elif args.batch_curve:
            run_batch_curve(args, device)
        else:
            run_per_layer(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
