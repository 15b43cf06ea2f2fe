#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (caffe_escoin_tpu_torch) on one GPU.

Drives the port's inference paths the way ``bench.py``'s ``run_e2e``
composes them (without packing or buckets), first on the hand-written
kernels' routes (``use_xla_sparse=False``):

* ResNet-50 at batch 32, 224x224, conv and fc weights pruned to 90% in
  128x128 blocks (the 3-channel stem stays dense), BatchNorm/Scale/ReLU/
  residual fused into the convs;
* VGG-16 at batch 16, 224x224, full width, the same pruning (each pruned
  weight scaled back to its norm, so that the signal survives thirteen
  pruned convs and three pruned fcs), fc6/fc7 ReLU fused, Dropout kept as
  the inference identity;

both weight-aligned to BSC and run in SCONV_PAR mode in bf16 on the card;
then ResNet-50 as a bare ``python bench.py`` runs it: the XBSP arms,
measured autotune and whole-graph calibration (phase 4b); then ResNet-50
as ``bench.py --granularity unstructured`` prunes it, element-wise, run
through the ELL gather SpMM (phase 4c).

Phases, one line each (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: the three CUDA kernels from the sources in this checkout, and
     nvcc's register and spill report per kernel template and Rows policy
     (the direct convs' instances apart from the SpMM's).
  3. parity: each kernel against its plain PyTorch version at main-path
     shapes, bf16, max|err| <= 1e-2 * max|plain| + 1e-2, after the launch
     plan (tile rows, ring stages, shared bytes) of each direct conv at
     that shape: sconv_fused at ResNet-50 shapes and at VGG-16 conv3_1,
     conv4_2 and conv5_2; bsc_spmm at ResNet-50 fc1000, VGG-16 fc6, fc7
     and fc8 (128x128 blocks) and conv1_2's lowered im2col GEMM (64x64
     blocks); sconv_gc at VGG-16 conv2_1, conv2_2 and conv3_2, and
     sconv_fused at those three too.
  3b. the XBSP arms (torch ops, no kernel of this package): unroll,
     gathered and gathered_cols at three ResNet-50 shapes (on the padded
     3x3 one also in the ``CESCOIN_XBSP_NOPAD`` pad-free form) and spmm at
     fc1000, in bf16, each against the f32 conv (``conv2d_dense``) or
     matmul (``linear``) on the f32 dense pruned weight, TF32 off, within
     the same limit; each timed eager and as a CUDA graph beside the dense
     bf16 cuDNN conv (or ``torch.addmm``) and its bound. Also the ELL gather
     SpMM (kernels/spmm.ell_spmm, torch ops) at res2's 3x3 (the ELL of
     W^T, 64 x 576 pruned element-wise to 90%, against the im2col's
     transpose, M = 32*56*56) in bf16 against the f32 product, timed
     beside ``torch.sparse.mm`` on a CSR of the same weight (cuSPARSE, the
     library the reference's csrmm2 path calls; never on the port's path)
     and its bound.
  4. nets, each on 4 distinct inputs with every launch counter set to 0
     just before and read just after: every kernel must have launched as
     many times as the layers' routes (``Net.routes``, the function the
     dispatch runs through) say; the last classifier's logits within 5e-2
     relative L2 of the same pruned, fused net run dense in f32 (cuDNN,
     TF32 off). Also the routing's host time per layer (``Net.routes``,
     host clock).
  4b. ResNet-50 b32 autotuned, configured as bench.py's ``pol_sparse``:
     the XBSP branch (``use_xla_sparse``) with ``autotune`` on and
     ``CESCOIN_AUTOTUNE_FUSED=1`` (the fused kernel competes), on the same
     pruned, fused weights and the same 4 inputs as the ResNet-50 row, the
     cache in a fresh file under ``build/``. ``calibrate_graph`` with
     polish 8 under ``net_scope("resnet50")``, three times, each from an
     emptied cache (``autotune.clear()``, the file removed). Its
     ``time_fn`` is ``device_time`` of the whole forward, which captures
     the forward anew on each call (the trials change the routes) and
     times CUDA-graph replays cycling the 4 inputs; ``measure_arms`` times
     every candidate the same way. The first forward of each run measures
     every key; an arm or a forward that raises fails the run. Each run's
     ``calib`` line, every key's isolated arm times (each key must hold
     every arm, ``fused`` wherever ``sconv_fused.supported`` and the
     reference's size gate ``fits_budget`` take the key), each key's arm
     in the three runs and whether they agree. Then, on the last run's
     picks: the routes served from the cache, launches (``sconv_fused``
     once per "fused" route), the logits against dense f32 (same limit),
     the forward eager, as a CUDA graph and through
     ``inference_fn(cuda_graph=True)``, beside the kernel-route row's; the
     run fails if the autotuned CUDA graph takes more than
     ``AUTOTUNED_GRAPH_LIMIT`` times the kernel route's. Then the
     per-layer split by arm. No arm is measured during a CUDA-graph
     capture: autotune raises if it would.
  4c. ResNet-50 b32 unstructured: the kernel-route row's random weights
     (seed 0), its conv weights (the stem stays dense) pruned element-wise
     to 90% with ``prune_conv_weight(w, 0.9, None)`` and fc1000 with
     ``prune_magnitude``, fused, aligned under LOWERED_SPARSE with
     ``sparse_format=ELL`` (128x128 blocks for the BSC it also builds), in
     bf16. Routes (``Net.routes``): conv1 dense, the other 52 convs "ell",
     fc1000 dense (every 128x128 block of it is live). Every launch counter
     must read 0 over the 4 forwards: this path runs no hand kernel. The
     logits within 5e-2 relative L2 of the same pruned net run dense in
     f32; the forward eager, each layer alone as a CUDA graph, and each ELL
     layer's width and nnz.
  5. times (CUDA events, after warm-up, cycling the 4 inputs): each net
     sparse, dense-bf16 and dense-f32, eager, and the sparse forward
     replayed as a CUDA graph (its device time, without the host's
     dispatch); then each layer's device time in one sparse forward (the
     layer alone as a CUDA graph on its inputs), by route. Each kernel
     beside its plain version, one PyTorch library call computing the same
     function (``F.conv2d`` on the dense bf16 weight, channels_last, with
     bias, for a conv; ``torch.addmm`` with the dense weight for an SpMM;
     the port never calls either), and sconv_gc beside sconv_fused on the
     same layer, each arm timed eager (20 calls between CUDA events, host
     dispatch included) and as a CUDA graph of 20 calls (device time).
     Each line also gives the case's bound: the larger of its bytes over
     the card's memory rate and its FLOPs over the bf16 tensor-core rate
     (``BOUND_RATES``). The bytes count, once each, the columns of x (or
     of an SpMM's A) that some live weight block reads, the live weight
     blocks, the output and the residual; the FLOPs count the live
     blocks. Also the host time of one entry call of each kernel.
Then one JSON line with the kernels: ``ms``, ``plain_ms`` and
``library_ms`` are eager times summed over the timed shapes, ``graph_ms``,
``graph_plain_ms`` and ``graph_library_ms`` the same as CUDA graphs;
``launches`` sums the nets' runs (phases 4, 4b and 4c). As the last line
{"ok": true, "device": {...}}.

Run from the repository root: ``python3 chip_smoke.py``. Needs one CUDA
device and nvcc; exits 1 without them.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SPARSITY = 0.9
BLOCK = (128, 128)
SEED = 0
N_INPUTS = 4
TIMED_ITERS = 20
PARITY_REL, PARITY_ABS = 1e-2, 1e-2
LOGITS_REL_L2 = 5e-2
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16
# tensor-core FLOP/s, at the full 700 W power limit
BOUND_RATES = {"bytes": 3.35e12, "operations": 989e12}
KERNELS = {  # name -> the TPU kernel it replaces
    "sconv_fused": "caffe_escoin_tpu/kernels/sconv_fused.py:263",
    "bsc_spmm": "caffe_escoin_tpu/kernels/bsc_pallas.py:125",
    "sconv_gc": "caffe_escoin_tpu/kernels/sconv_pallas.py:157",
}
# logits: the last classifier's blob; input_scale: the std of the random
# inputs; keep_norm: see _prune
NETS = [
    dict(model="resnet50", batch=32, logits="fc1000", width=1000,
         input_scale=0.1, keep_norm=False),
    dict(model="vgg16", batch=16, logits="fc8", width=1000,
         input_scale=1.0, keep_norm=True),
]
ROUTE_REPS = 100
# the autotuned row: bench.py's calibration (polish 8, net scope), and a
# cache file of this run's own (gitignored, deleted first)
CALIB_POLISH = 8
CALIB_REPS = 8
CALIB_RUNS = 3
AUTOTUNE_CACHE = "build/chip_smoke_autotune.json"
# the autotuned forward as a CUDA graph may take at most this many times the
# kernel route's: its router reads device time, and the fused kernel is
# among its candidates
AUTOTUNED_GRAPH_LIMIT = 1.15


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0].strip()


def _time_ms(fn, args, iters=TIMED_ITERS):
    """Mean ms per call over ``iters`` calls cycling ``args``, CUDA events,
    after one warm-up pass over every argument."""
    import torch

    for a in args:
        fn(a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(args[i % len(args)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, args, iters=TIMED_ITERS):
    """Mean device ms per call: ``iters`` calls cycling ``args`` captured in
    one CUDA graph, replayed between CUDA events after warm-up. The host's
    dispatch drops out, so a short kernel is timed, not the Python that
    launches it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in args:
            fn(a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(args[i % len(args)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def _layer_split(layers, fwd, x):
    """Device ms of each layer of one sparse forward on ``x``: every layer
    replayed alone as a CUDA graph (``_graph_ms``) on the inputs it got in
    that forward (recorded by module hooks)."""
    import torch

    calls, hooks = [], []
    for layer in layers:
        hooks.append(layer.register_forward_pre_hook(
            lambda mod, args: calls.append((mod, args))))
    try:
        fwd(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    with torch.inference_mode():
        return {mod.spec.name: _graph_ms(lambda a, mod=mod: mod(*a), [args],
                                         iters=5)
                for mod, args in calls}


def _bound(nbytes, flops):
    """(ms, what sets it): the least time the card could take for work
    that moves ``nbytes`` and does ``flops`` bf16 tensor-core operations."""
    ms = {k: v / BOUND_RATES[k] * 1e3
          for k, v in (("bytes", nbytes), ("operations", flops))}
    by = max(ms, key=ms.get)
    return ms[by], by


def _nopad(fn, x):
    """``fn(x)`` with ``CESCOIN_XBSP_NOPAD=1``: the XBSP arms' pad-free
    slab form, which they read per call."""
    os.environ["CESCOIN_XBSP_NOPAD"] = "1"
    try:
        return fn(x)
    finally:
        del os.environ["CESCOIN_XBSP_NOPAD"]


def _check_arms(net, params, shapes, measured):
    """(keys, keys with "fused"): every arm competed on every measured key,
    the fused kernel wherever the dispatcher would run it
    (``sconv_fused.supported`` and the reference's size gate
    ``fits_budget``). Each key is mapped back to its conv as the
    dispatcher forms it (a strided 1x1 conv on its subsampled map); raises
    SystemExit otherwise."""
    import torch

    from caffe_escoin_tpu_torch.engine import autotune
    from caffe_escoin_tpu_torch.kernels import sconv_fused
    from caffe_escoin_tpu_torch.ops import conv as conv_ops
    from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight

    dtype = net.policy.compute_dtype or torch.float32
    seen, n_fused = set(), 0
    for layer, in_shapes in net.walk_shapes(shapes):
        al = params.get(layer.spec.name)
        if (layer.spec.type not in ("Convolution", "ConvolutionReLU")
                or not isinstance(al, AlignedConvWeight) or al.bsc is None):
            continue
        c = layer._conf(in_shapes[0])
        stride, pad, dil = (tuple(c[k]) for k in ("stride", "pad",
                                                  "dilation"))
        x = torch.empty(in_shapes[0], dtype=dtype, device="meta")
        if stride != (1, 1) and al.kernel_shape == (1, 1):
            x = conv_ops._subsampled(x, stride, pad)
            stride, pad = (1, 1), (0, 0)
        key = autotune.cache_key(al, x.shape, stride, pad, dil, dtype)
        if key not in measured or key in seen:
            continue
        seen.add(key)
        want = {"unroll", "gathered", "gathered_cols", "dense"}
        if (sconv_fused.supported(x, al, stride=stride, dilation=dil)
                and sconv_fused.fits_budget(x, al, pad)):
            want.add("fused")
            n_fused += 1
        if set(measured[key]) != want:
            raise SystemExit(f"autotune: {layer.spec.name} measured "
                             f"{sorted(measured[key])}, expected "
                             f"{sorted(want)}")
    if seen != set(measured):
        raise SystemExit(f"autotune: {len(set(measured) - seen)} measured "
                         f"keys belong to no conv of the net")
    return len(seen), n_fused


def _prune(net, params, keep_norm=False, block=BLOCK):
    """bench.py's pruning: conv and fc weights at SPARSITY in ``block``
    blocks, or element-wise with ``block=None`` (``--granularity
    unstructured``). The stem (3 input channels) stays dense.
    ``keep_norm`` scales each pruned weight back to its Frobenius norm,
    which bench.py does not: it keeps the signal alive through VGG-16's
    sixteen pruned layers."""
    import torch

    from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,
                                                      prune_conv_weight,
                                                      prune_magnitude)

    out = dict(params)
    for layer in net.layers:
        name, kind = layer.spec.name, layer.spec.type
        if name not in out or kind not in ("Convolution", "ConvolutionReLU",
                                           "InnerProduct"):
            continue
        q = dict(out[name])
        w = q["w"].numpy()
        if kind == "InnerProduct":
            wp = (prune_magnitude(w, SPARSITY) if block is None
                  else prune_blocks(w, SPARSITY, block))
        elif w.shape[2] >= 32:
            wp = prune_conv_weight(w, SPARSITY, block)
        else:
            continue
        if keep_norm:
            wp = wp * np.float32(np.linalg.norm(w) / np.linalg.norm(wp))
        q["w"] = torch.from_numpy(wp)
        out[name] = q
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from caffe_escoin_tpu_torch.engine import autotune
        from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                           ExecutionPolicy)
        from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
        from caffe_escoin_tpu_torch.ops import conv as conv_ops
        from caffe_escoin_tpu_torch.ops import linear as linear_ops
        from caffe_escoin_tpu_torch.utils.benchmark import device_time
        from caffe_escoin_tpu_torch.kernels import (_build, bsc_spmm,
                                                    sconv_fused, sconv_gc)
        from caffe_escoin_tpu_torch.models import ZOO
        from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
        from caffe_escoin_tpu_torch.nn.layers import ROUTE_KERNELS
        from caffe_escoin_tpu_torch.engine.context import SparseFormat
        from caffe_escoin_tpu_torch.kernels.spmm import ell_spmm
        from caffe_escoin_tpu_torch.sparse import dense_to_bsc, dense_to_ell
        from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
        from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,
                                                          prune_conv_weight,
                                                          prune_magnitude)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 1
    mods = {"sconv_fused": sconv_fused, "bsc_spmm": bsc_spmm,
            "sconv_gc": sconv_gc}
    card = _card_line()
    print(card)
    tag = f"[{card}]"
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(dev)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, TF32 off {tag}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    built = _build.build_seconds
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'nvcc ' + format(built, '.1f') + ' s' if built else 'cached'}, "
          f"{_build.library_path().name}) {tag}")
    if _build.ptxas_log:
        # one summary per kernel template and Rows policy (and split-K
        # instance): the entries of nvcc's -Xptxas -v report, grouped by
        # the names in their mangled symbol
        fams = collections.defaultdict(lambda: dict(n=0, regs=[], smem=[],
                                                    spill=0))
        for entry in re.split(r"Compiling entry function", _build.ptxas_log
                              )[1:]:
            symbol = entry.split("\n", 1)[0]
            kern = re.search(r"\d([a-z][a-z_]*_kernel)I", symbol)
            rows = re.search(r"\d([A-Za-z]+Rows)", symbol)
            fam = fams[(kern.group(1) if kern else "other")
                       + (f"<{rows.group(1)}" if rows else "<")
                       + (", split>" if "Lb1E" in symbol else ">")]
            fam["n"] += 1
            fam["regs"] += [int(r) for r in
                            re.findall(r"Used (\d+) registers", entry)]
            fam["smem"] += [int(b) for b in
                            re.findall(r"(\d+) bytes smem", entry)] or [0]
            fam["spill"] += sum(int(b) for b in
                                re.findall(r"(\d+) bytes spill", entry))
        print("ptxas: " + "; ".join(
            f"{k} {f['n']} instances, {min(f['regs'])}-{max(f['regs'])} "
            f"registers, {min(f['smem'])}-{max(f['smem'])} B static shared, "
            f"{f['spill']} B spilled" for k, f in fams.items()) + f" {tag}")

    # ---- 3. kernel parity at main-path shapes -----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng_np = np.random.default_rng(SEED)
    pol_block = ExecutionPolicy(block_shape=BLOCK)
    results = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                       graph_ms=0.0, graph_plain_ms=0.0,
                       graph_library_ms=0.0, bound_ms=0.0, launches=0,
                       bound={"bytes": 0.0, "operations": 0.0})
               for k in KERNELS}
    timed = []  # (kernel, label, {arm: fn}, args, bytes, flops)

    def check(kernel, label, out, ref):
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        bound = PARITY_REL * scale + PARITY_ABS
        ok = bool(torch.isfinite(out).all()) and err <= bound
        print(f"parity {kernel} {label}: max_abs_err {err:.3e} "
              f"(bound {bound:.3e}, max|ref| {scale:.3e}) "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"{kernel} {label}: disagrees with its "
                             f"reference")
        if kernel in results:
            results[kernel]["err"] = max(results[kernel]["err"], err)

    def conv_weight(cin, cout, k):
        w = prune_conv_weight(
            rng_np.standard_normal((k, k, cin, cout)).astype("float32")
            * (2.0 / (k * k * cin)) ** 0.5, SPARSITY, (min(128, cin), 128))
        b = rng_np.standard_normal(cout).astype("float32") * 0.1
        return weight_align(w, b, policy=pol_block).to(dev, torch.bfloat16)

    def conv_case(batch, h, cin, cout, k, with_res):
        al = conv_weight(cin, cout, k)
        xs = [torch.randn((batch, h, h, cin), generator=gen, device=dev
                          ).bfloat16() for _ in range(N_INPUTS)]
        res = (torch.randn((batch, h, h, cout), generator=gen, device=dev
                           ).bfloat16() if with_res else None)
        return al, xs, res

    def live_bytes(bsc):
        bk, bn = bsc.block_shape
        return bsc.nnz_blocks * bk * bn * 2

    def live_cols(bsc, n_kb, width):
        """Columns of the activation (x's channels, or A's K columns) that
        some live block reads: the K-block rows with a live block in any
        block-column, taken mod the ``n_kb`` K-blocks one row of the
        activation spans (a 3x3 conv's nine offsets share x's channels),
        each clipped to ``width``."""
        bk = bsc.block_shape[0]
        rows, nnz = bsc.block_row.cpu(), bsc.bcol_nnz.cpu()
        live = torch.arange(rows.shape[1])[None, :] < nnz[:, None]
        blocks = {int(r) % n_kb for r in rows[live].tolist()}
        return sum(max(0, min(bk, width - b * bk)) for b in blocks)

    def conv_work(al, x, with_res):
        """(bytes, FLOPs) of a stride-1 same-size conv (every timed conv
        keeps its spatial size): the channels of x that a live block reads,
        the live blocks, out and the residual once each; two FLOPs per
        multiply-add of the live blocks."""
        bk, bn = al.bsc.block_shape
        m = x.shape[0] * x.shape[1] * x.shape[2]
        x_cols = live_cols(al.bsc, al.cin_pad // bk, al.cin)
        out = m * al.cout * 2
        return (m * x_cols * 2 + live_bytes(al.bsc)
                + out * (2 if with_res else 1),
                2 * m * al.bsc.nnz_blocks * bk * bn)

    def conv_library(al, pad):
        """cuDNN on the dense bf16 weight, channels_last, with bias: one
        library call for the conv (no residual or ReLU)."""
        w = al.dense.to(dev, torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b = al.bias.to(dev, torch.bfloat16)
        return lambda x: F.conv2d(x.permute(0, 3, 1, 2), w, b,
                                  padding=(pad, pad))

    sconv_shapes = [  # (label, batch, h, cin, cout, k, pad, relu, residual)
        ("b32 56x56 64->64 3x3", 32, 56, 64, 64, 3, 1, False, False),
        ("b32 14x14 1024->256 1x1", 32, 14, 1024, 256, 1, 0, False, False),
        ("b32 7x7 512->2048 1x1 +res+relu", 32, 7, 512, 2048, 1, 0, True,
         True),
        ("conv3_1 b16 56x56 128->256 3x3 +relu", 16, 56, 128, 256, 3, 1,
         True, False),
        ("conv4_2 b16 28x28 512->512 3x3 +relu", 16, 28, 512, 512, 3, 1,
         True, False),
        ("conv5_2 b16 14x14 512->512 3x3 +relu", 16, 14, 512, 512, 3, 1,
         True, False),
    ]
    for label, batch, h, cin, cout, k, pad, relu, with_res in sconv_shapes:
        al, xs, res = conv_case(batch, h, cin, cout, k, with_res)

        def kern(x, al=al, pad=pad, relu=relu, res=res):
            return sconv_fused.sconv(x, al, padding=(pad, pad), relu=relu,
                                     residual=res)

        def plain(x, al=al, pad=pad, relu=relu, res=res):
            return sconv_fused.sconv_plain(x, al, padding=(pad, pad),
                                           relu=relu, residual=res,
                                           mxu_dtype="bfloat16")

        print(f"plan sconv_fused {label}: "
              f"{sconv_fused.launch_plan(xs[0].shape, al, (pad, pad))} {tag}")
        out = kern(xs[0])
        torch.cuda.synchronize()
        check("sconv_fused", label, out, plain(xs[0]))
        timed.append(("sconv_fused", label,
                      {"kernel": kern, "plain": plain,
                       "library": conv_library(al, pad)}, xs,
                      *conv_work(al, xs[0], with_res)))

    def spmm_case(label, m, bsc, relu):
        bias = torch.randn(bsc.shape[1], generator=gen, device=dev) * 0.1
        a_list = [torch.randn((m, bsc.shape[0]), generator=gen, device=dev
                              ).bfloat16() for _ in range(N_INPUTS)]
        w_dense, bias_bf16 = bsc.to_dense().to(torch.bfloat16), bias.bfloat16()

        def kern(a):
            return bsc_spmm.bsc_spmm(a, bsc, bias=bias, relu=relu)

        def plain(a):
            return bsc_spmm.bsc_spmm_plain(a, bsc, bias=bias, relu=relu,
                                           mxu_dtype="bfloat16")

        def library(a):
            return torch.addmm(bias_bf16, a, w_dense)

        out = kern(a_list[0])
        torch.cuda.synchronize()
        check("bsc_spmm", label, out, plain(a_list[0]))
        bk, bn = bsc.block_shape
        a_cols = live_cols(bsc, bsc.n_brows, bsc.shape[0])
        timed.append(("bsc_spmm", label, {"kernel": kern, "plain": plain,
                                          "library": library}, a_list,
                      m * a_cols * 2 + live_bytes(bsc)
                      + m * bsc.shape[1] * 2,
                      2 * m * bsc.nnz_blocks * bk * bn))

    for label, m, k, n, relu in [  # the fc layers, 128x128 blocks
            ("fc1000 32x2048->1000", 32, 2048, 1000, False),
            ("fc6 16x25088->4096 +relu", 16, 25088, 4096, True),
            ("fc7 16x4096->4096 +relu", 16, 4096, 4096, True),
            ("fc8 16x4096->1000", 16, 4096, 1000, False)]:
        w = prune_blocks(rng_np.standard_normal((k, n)).astype("float32")
                         * (3.0 / k) ** 0.5, SPARSITY, BLOCK)
        spmm_case(label, m, dense_to_bsc(w, BLOCK).to(dev, torch.bfloat16),
                  relu)
    # conv1_2's lowered route: its im2col [16*224*224, 9*64] against the
    # GEMM-view weight, which weight_align cuts in 64x64 blocks
    spmm_case("conv1_2 lowered b16 802816x576->64 +relu", 16 * 224 * 224,
              conv_weight(64, 64, 3).bsc, True)

    gc_shapes = [  # (label, batch, h, cin, cout): VGG-16 3x3 pad-1 layers
        ("conv2_1 b16 112x112 64->128 3x3 +relu", 16, 112, 64, 128),
        ("conv2_2 b16 112x112 128->128 3x3 +relu", 16, 112, 128, 128),
        ("conv3_2 b16 56x56 256->256 3x3 +relu", 16, 56, 256, 256),
    ]
    for label, batch, h, cin, cout in gc_shapes:
        al, xs, _ = conv_case(batch, h, cin, cout, 3, False)

        def gc_kern(x, al=al):
            return sconv_gc.sconv(x, al, padding=(1, 1), relu=True)

        def gc_plain(x, al=al):
            return sconv_gc.sconv_plain(x, al, padding=(1, 1), relu=True,
                                        mxu_dtype="bfloat16")

        def fused_kern(x, al=al):
            return sconv_fused.sconv(x, al, padding=(1, 1), relu=True)

        for name, mod in (("sconv_gc", sconv_gc),
                          ("sconv_fused", sconv_fused)):
            print(f"plan {name} {label}: "
                  f"{mod.launch_plan(xs[0].shape, al, (1, 1))} {tag}")
        out, out_fused = gc_kern(xs[0]), fused_kern(xs[0])
        torch.cuda.synchronize()
        ref = gc_plain(xs[0])
        check("sconv_gc", label, out, ref)
        check("sconv_fused", label, out_fused, ref)
        timed.append(("sconv_gc", label, {"kernel": gc_kern,
                                          "plain": gc_plain,
                                          "library": conv_library(al, 1),
                                          "sconv_fused": fused_kern}, xs,
                      *conv_work(al, xs[0], False)))

    # ---- 3b. the XBSP arms against the f32 dense conv ----------------------
    def time_line(what, label, arms, args, nbytes, flops):
        """Each arm eager and as a CUDA graph, beside the bound."""
        graph = {arm: _graph_ms(fn, args) for arm, fn in arms.items()}
        eager = {arm: _time_ms(fn, args) for arm, fn in arms.items()}
        bound_ms, bound_by = _bound(nbytes, flops)
        print(f"time {what} {label}, as a CUDA graph (eager): "
              + ", ".join(f"{arm} {graph[arm]:.4f} ({eager[arm]:.4f}) ms"
                          for arm in arms)
              + f"; bound {bound_ms * 1e3:.1f} us ({bound_by}) {tag}")

    xbsp_cases = [  # (label, batch, h, cin, cout, k, pad, relu, residual)
        sconv_shapes[0], sconv_shapes[1], sconv_shapes[2]]
    # the nets below draw their inputs after this phase: keep the generators
    # where the kernel phases left them
    gen_state, np_state = gen.get_state(), rng_np.bit_generator.state
    with torch.inference_mode():
        for label, batch, h, cin, cout, k, pad, relu, with_res in xbsp_cases:
            al, xs, res = conv_case(batch, h, cin, cout, k, with_res)
            geo = dict(padding=(pad, pad), relu=relu)
            ref = conv_ops.conv2d_dense(
                xs[0].float(), al.dense.float(), al.bias,
                residual=None if res is None else res.float(), **geo)
            arms = {name: (lambda x, fn=fn, al=al, res=res, geo=geo:
                           fn(x, al, residual=res, **geo))
                    for name, fn in (("unroll", xbs.conv),
                                     ("gathered", xbs.conv_gathered),
                                     ("gathered_cols",
                                      xbs.conv_gathered_cols))}
            if pad:  # the CESCOIN_XBSP_NOPAD form differs only when padded
                arms.update({f"{name} pad-free": (
                    lambda x, fn=fn: _nopad(fn, x)) for name, fn in
                    list(arms.items())})
            for name, fn in arms.items():
                out = fn(xs[0])
                torch.cuda.synchronize()
                check(f"xbsp {name}", label, out, ref)
            arms["dense bf16 (cuDNN)"] = conv_library(al, pad)
            time_line("xbsp", label, arms, xs,
                      *conv_work(al, xs[0], with_res))
        w = prune_blocks(rng_np.standard_normal((2048, 1000)).astype(
            "float32") * (3.0 / 2048) ** 0.5, SPARSITY, BLOCK)
        bsc = dense_to_bsc(w, BLOCK).to(dev, torch.bfloat16)
        bias = torch.randn(1000, generator=gen, device=dev) * 0.1
        a_list = [torch.randn((32, 2048), generator=gen, device=dev
                              ).bfloat16() for _ in range(N_INPUTS)]
        w_dense = bsc.to_dense()
        out = xbs.spmm(a_list[0], bsc, bias=bias)
        torch.cuda.synchronize()
        check("xbsp spmm", "fc1000 32x2048->1000", out,
              linear_ops.linear(a_list[0].float(), w_dense.float(), bias))
        bias_bf16 = bias.bfloat16()
        time_line("xbsp", "fc1000 32x2048->1000",
                  {"spmm": lambda a: xbs.spmm(a, bsc, bias=bias),
                   "addmm": lambda a: torch.addmm(bias_bf16, a, w_dense)},
                  a_list,
                  32 * live_cols(bsc, bsc.n_brows, 2048) * 2
                  + live_bytes(bsc) + 32 * 1000 * 2,
                  2 * 32 * bsc.nnz_blocks * BLOCK[0] * BLOCK[1])
        # the ELL gather SpMM at res2's 3x3: the ELL of W^T [64, 576]
        # against the im2col's transpose [576, 32*56*56]
        m_ell = 32 * 56 * 56
        w_t = torch.from_numpy(prune_magnitude(
            rng_np.standard_normal((64, 576)).astype("float32")
            * (2.0 / 576) ** 0.5, SPARSITY)).bfloat16()
        ell = dense_to_ell(w_t.float().numpy(), lane_pad=8).to(
            dev, torch.bfloat16)
        w_t = w_t.to(dev)
        w_csr = w_t.to_sparse_csr()
        b_list = [torch.randn((576, m_ell), generator=gen, device=dev
                              ).bfloat16() for _ in range(N_INPUTS)]
        out = ell_spmm(ell, b_list[0])
        torch.cuda.synchronize()
        label = f"res2 3x3 W^T 64x576 ({ell.nnz} nnz, width {ell.width}) @ " \
                f"576x{m_ell}"
        check("ell_spmm", label, out, w_t.float() @ b_list[0].float())
        live_k = int((w_t != 0).any(dim=0).sum())
        time_line("ell", label,
                  {"ell_spmm": lambda b: ell_spmm(ell, b),
                   "torch.sparse.mm (cuSPARSE CSR)":
                       lambda b: torch.sparse.mm(w_csr, b)},
                  b_list,
                  live_k * m_ell * 2 + ell.values.numel() * 6
                  + 64 * m_ell * 4, 2 * ell.nnz * m_ell)
        del b_list, out
    gen.set_state(gen_state)
    rng_np.bit_generator.state = np_state

    # ---- 4. the nets ------------------------------------------------------
    pol_s = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                            compute_dtype=torch.bfloat16, cast_back=False,
                            use_xla_sparse=False)
    e2e = []  # (model, batch, {arm: fn}, inputs f32, inputs bf16)
    kept = {}  # model -> what the autotuned row reuses
    for cfg in NETS:
        model, batch = cfg["model"], cfg["batch"]
        logits_blob, width = cfg["logits"], cfg["width"]
        t0 = time.perf_counter()
        build, shapes = ZOO[model]
        shapes = {"data": (batch,) + tuple(shapes["data"][1:])}
        net = Net(build(), policy=pol_s)
        params = net.init(torch.Generator().manual_seed(SEED), shapes)
        pruned = _prune(net, params, keep_norm=cfg["keep_norm"])
        fnet, fparams = fuse_inference(net, pruned, state=net.state0)
        aligned = fnet.weight_align(fparams)
        routes = fnet.routes(aligned, shapes)
        t1 = time.perf_counter()
        for _ in range(ROUTE_REPS):
            fnet.routes(aligned, shapes)
        route_us = ((time.perf_counter() - t1) / ROUTE_REPS / len(routes)
                    * 1e6)
        expect = collections.Counter(
            ROUTE_KERNELS[r] for r in routes.values() if r in ROUTE_KERNELS)
        sparse_params = params_to(aligned, dev, torch.bfloat16)
        dense_net = Net(fnet.specs, policy=ExecutionPolicy())
        dense_params = params_to(fparams, dev)
        dense_bf16_net = Net(fnet.specs, policy=ExecutionPolicy(
            compute_dtype=torch.bfloat16, cast_back=False))
        dense_bf16_params = params_to(fparams, dev, torch.bfloat16)
        xs = [torch.randn(shapes["data"], generator=gen, device=dev)
              * cfg["input_scale"] for _ in range(N_INPUTS)]
        print(f"net: {model} b{batch} {shapes['data'][1]}x"
              f"{shapes['data'][2]}, {len(net.layers)} -> {len(fnet.layers)} "
              f"layers after fusion, {SPARSITY:.0%} sparsity in "
              f"{BLOCK[0]}x{BLOCK[1]} blocks, set-up "
              f"{time.perf_counter() - t0:.1f} s; routes "
              f"{dict(collections.Counter(routes.values()))}; expected "
              f"launches per forward: {dict(expect)} {tag}")
        print(f"net {model} routing host time: {route_us:.2f} us per layer "
              f"(Net.routes over {len(routes)} conv/fc layers, mean of "
              f"{ROUTE_REPS}, host clock) {tag}")

        fwd_s = fnet.inference_fn(sparse_params, return_blobs=True)
        fwd_d = dense_net.inference_fn(dense_params, return_blobs=True)
        fwd_db = dense_bf16_net.inference_fn(dense_bf16_params)
        for m in mods.values():
            m.reset_counts()
        sparse_out = [fwd_s({"data": x}) for x in xs]
        torch.cuda.synchronize()
        launches = {k: m.launches for k, m in mods.items()}
        print(f"net {model} launches over {N_INPUTS} forwards: {launches} "
              f"(expected {N_INPUTS} x {dict(expect)}) {tag}")
        for name, n in launches.items():
            if n != N_INPUTS * expect[name]:
                raise SystemExit(f"{model} launched {name} {n} times, "
                                 f"expected {N_INPUTS * expect[name]}")
            results[name]["launches"] += n
        if not all(launches[k] for k in expect):
            raise SystemExit(f"{model}: a kernel of its path never launched")
        num, den, peak = 0.0, 0.0, 0.0
        for x, so in zip(xs, sparse_out):
            prob, logits = so["prob"], so[logits_blob].float()
            if prob.shape != (batch, width) or not torch.isfinite(prob).all() \
                    or not torch.isfinite(logits).all():
                raise SystemExit(f"{model} output is not finite "
                                 f"[{batch}, {width}]")
            if (prob.float().sum(-1) - 1).abs().max().item() > 2e-2:
                raise SystemExit(f"{model} softmax rows do not sum to 1")
            ref = fwd_d({"data": x})[logits_blob]
            num += (logits - ref).pow(2).sum().item()
            den += ref.pow(2).sum().item()
            peak = max(peak, ref.abs().max().item())
        rel_l2 = (num / den) ** 0.5
        ok = rel_l2 <= LOGITS_REL_L2
        print(f"net {model} {logits_blob} logits vs dense f32: rel L2 "
              f"{rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}), max|logit| "
              f"{peak:.3e} {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"sparse {model} disagrees with dense f32")
        kept[model] = dict(net=net, init=params, specs=fnet.specs,
                           params=sparse_params, xs=xs,
                           shapes=shapes, fwd_s=fwd_s, fwd_d=fwd_d)
        e2e.append((model, batch, fnet.layers, routes,
                    {"sparse": fwd_s, "dense-bf16": fwd_db,
                     "dense-f32": fwd_d},
                    [{"data": x} for x in xs],
                    [{"data": x.bfloat16()} for x in xs]))
        del sparse_out

    # ---- 4b. ResNet-50 b32 autotuned ---------------------------------------
    row = kept["resnet50"]
    os.environ["CESCOIN_AUTOTUNE_FUSED"] = "1"
    os.makedirs(os.path.dirname(AUTOTUNE_CACHE), exist_ok=True)
    pol_at = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                             compute_dtype=torch.bfloat16, cast_back=False,
                             use_xla_sparse=True, autotune=True,
                             autotune_cache=AUTOTUNE_CACHE)
    at_net = Net(row["specs"], policy=pol_at)
    at_inputs = [{"data": x} for x in row["xs"]]
    at_fwd = at_net.inference_fn(row["params"], return_blobs=True)

    def fwd_at(inputs):
        with autotune.net_scope("resnet50"):
            return at_fwd(inputs)

    def time_sparse():
        # captures the forward anew: the trials change its routes
        return device_time(lambda y: fwd_at({"data": y})["prob"],
                           row["xs"][0], iters=CALIB_REPS,
                           arg_sets=[(x,) for x in row["xs"]])

    x_mb = row["xs"][0].numel() * row["xs"][0].element_size() / 1e6
    picks = []  # per run: key -> arm
    for run in range(CALIB_RUNS):
        if os.path.exists(AUTOTUNE_CACHE):
            os.remove(AUTOTUNE_CACHE)
        autotune.clear()
        t0 = time.perf_counter()
        calib = autotune.calibrate_graph(
            time_sparse, polish=CALIB_POLISH, net_tag="resnet50",
            cache_path=AUTOTUNE_CACHE,
            log=lambda m: print(f"calib-log {m}", flush=True))
        wall = time.perf_counter() - t0
        measured = autotune.report()
        picks.append(calib["arms"])
        print(f"calib resnet50 b32 autotuned, run {run + 1} of {CALIB_RUNS} "
              f"from an empty cache: t_first {calib['t_first'] * 1e3:.3f} "
              f"ms, t_isolated {calib['t_isolated'] * 1e3:.3f} ms, t_dense "
              f"{calib['t_dense'] * 1e3:.3f} ms, t_final "
              f"{calib['t_final'] * 1e3:.3f} ms; flips {calib['flips']}, "
              f"polish trials {calib.get('polish_trials', 0)}; "
              f"{calib['keys']} keys, {calib['sparse_keys']} sparse; arms "
              f"{dict(collections.Counter(calib['arms'].values()))}; "
              f"{len(measured)} keys measured, measurement + calibration "
              f"{wall:.1f} s wall; device_time: CUDA-graph replays, median "
              f"of {CALIB_REPS}, cycling {N_INPUTS} inputs of {x_mb:.1f} MB "
              f"(measure_arms: 4 synthetic inputs per key) {tag}")
        for key, times in sorted(measured.items()):
            print(f"autotune run {run + 1} key {key}: " + " ".join(
                f"{arm}={t * 1e6:.1f}us" for arm, t in sorted(times.items()))
                + f" -> {min(times, key=times.get)} {tag}")
        n_keys, n_fused = _check_arms(at_net, row["params"], row["shapes"],
                                      measured)
        print(f"autotune run {run + 1}: every arm measured on all {n_keys} "
              f"keys, the fused kernel on the {n_fused} the dispatcher "
              f"would run it on {tag}")
    keys = sorted(set().union(*picks))
    agree = [k for k in keys if len({p.get(k) for p in picks}) == 1]
    for k in keys:
        print(f"calib arms per run, key {k}: "
              + ", ".join(str(p.get(k)) for p in picks) + f" {tag}")
    print(f"calib: the {CALIB_RUNS} runs picked the same arm on "
          f"{len(agree)} of {len(keys)} keys: "
          f"{'agree' if len(agree) == len(keys) else 'DIFFER'} {tag}")
    n_measured = len(autotune.report())
    with autotune.net_scope("resnet50"):
        at_routes = at_net.routes(row["params"], row["shapes"])
    if len(autotune.report()) != n_measured:
        raise SystemExit("Net.routes measured an arm: the cache was not "
                         "complete after calibration")
    at_expect = collections.Counter(
        ROUTE_KERNELS[r] for r in at_routes.values() if r in ROUTE_KERNELS)
    print(f"net resnet50 autotuned routes (served from the last run's "
          f"cache): {dict(collections.Counter(at_routes.values()))}; "
          + ", ".join(f"{n} {r}" for n, r in at_routes.items()) + f" {tag}")
    for m in mods.values():
        m.reset_counts()
    at_out = [fwd_at(i) for i in at_inputs]
    torch.cuda.synchronize()
    at_launches = {k: m.launches for k, m in mods.items()}
    print(f"net resnet50 autotuned launches over {N_INPUTS} forwards: "
          f"{at_launches} (expected {N_INPUTS} x {dict(at_expect)}: one "
          f"sconv_fused per \"fused\" route) {tag}")
    for name, n in at_launches.items():
        if n != N_INPUTS * at_expect[name]:
            raise SystemExit(f"autotuned resnet50 launched {name} {n} "
                             f"times, expected {N_INPUTS * at_expect[name]}")
        results[name]["launches"] += n
    num = den = 0.0
    for inputs, out in zip(at_inputs, at_out):
        logits = out["fc1000"].float()
        if not torch.isfinite(logits).all() or \
                not torch.isfinite(out["prob"].float()).all():
            raise SystemExit("autotuned resnet50 output is not finite")
        ref = row["fwd_d"](inputs)["fc1000"]
        num += (logits - ref).pow(2).sum().item()
        den += ref.pow(2).sum().item()
    rel_l2 = (num / den) ** 0.5
    ok = rel_l2 <= LOGITS_REL_L2
    print(f"net resnet50 autotuned fc1000 logits vs dense f32: rel L2 "
          f"{rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}) "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("autotuned resnet50 disagrees with dense f32")
    # the graph form of inference_fn: its first call per input shape runs
    # eagerly and captures, later calls copy the input in and replay
    at_graph_fwd = at_net.inference_fn(row["params"], cuda_graph=True)

    def fwd_at_graph(inputs):
        with autotune.net_scope("resnet50"):
            return at_graph_fwd(inputs)

    for inputs, out in zip(at_inputs[:2] * 2, at_out[:2] * 2):
        got = fwd_at_graph(inputs)["prob"].float()
        err = (got - out["prob"].float()).abs().max().item()
        if err > PARITY_REL * out["prob"].float().abs().max().item():
            raise SystemExit(f"inference_fn(cuda_graph=True) differs from "
                             f"the eager forward by {err:.3e}")
    del at_out
    at_ms = {}
    for label, fn in (("kernel routes", row["fwd_s"]), ("autotuned", fwd_at)):
        at_ms[f"{label} eager"] = _time_ms(fn, at_inputs)
        at_ms[f"{label} as a CUDA graph"] = _graph_ms(fn, at_inputs,
                                                      N_INPUTS)
    at_ms["autotuned through inference_fn(cuda_graph=True)"] = _time_ms(
        fwd_at_graph, at_inputs)
    if len(autotune.report()) != n_measured:
        raise SystemExit("an arm was measured after calibration")
    ratio = (at_ms["autotuned as a CUDA graph"]
             / at_ms["kernel routes as a CUDA graph"])
    ok = ratio <= AUTOTUNED_GRAPH_LIMIT
    print("time resnet50 b32: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in at_ms.items())
        + f"; autotuned graph / kernel-route graph {ratio:.3f} (limit "
        f"{AUTOTUNED_GRAPH_LIMIT}) {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit(f"the autotuned forward as a CUDA graph takes "
                         f"{ratio:.2f}x the kernel route's")
    with autotune.net_scope("resnet50"):
        per = _layer_split(at_net.layers, fwd_at, at_inputs[0])
    by_arm, n_arm = collections.Counter(), collections.Counter()
    for name, t in per.items():
        by_arm[at_routes.get(name, "other")] += t
        n_arm[at_routes.get(name, "other")] += 1
    print(f"layers resnet50 autotuned, device ms per forward, each layer "
          f"alone as a CUDA graph: sum {sum(per.values()):.3f}; by arm "
          + ", ".join(f"{r} {t:.3f} ({n_arm[r]} layers)"
                      for r, t in by_arm.most_common())
          + "; by layer " + ", ".join(
              f"{n} ({at_routes.get(n, '-')}) {t:.4f}"
              for n, t in sorted(per.items(), key=lambda kv: -kv[1]))
          + f" {tag}")
    del at_graph_fwd

    # ---- 4c. ResNet-50 b32 unstructured, through ELL -----------------------
    t0 = time.perf_counter()
    pruned = _prune(row["net"], row["init"], block=None)
    fnet, fparams = fuse_inference(row["net"], pruned,
                                   state=row["net"].state0)
    pol_ell = ExecutionPolicy(conv_mode=ConvMode.LOWERED_SPARSE,
                              sparse_format=SparseFormat.ELL,
                              block_shape=BLOCK, compute_dtype=torch.bfloat16,
                              cast_back=False)
    ell_net = Net(fnet.specs, policy=pol_ell)
    aligned = ell_net.weight_align(fparams)
    ell_routes = ell_net.routes(aligned, row["shapes"])
    n_ell = sum(r == "ell" for r in ell_routes.values())
    print(f"net resnet50 b32 unstructured: {SPARSITY:.0%} element-wise, "
          f"LOWERED_SPARSE with ELL, set-up {time.perf_counter() - t0:.1f} "
          f"s; routes {dict(collections.Counter(ell_routes.values()))} "
          f"{tag}")
    if (ell_routes["conv1"], ell_routes["fc1000"], n_ell) != (
            "dense", "dense", len(ell_routes) - 2):
        raise SystemExit(f"unstructured resnet50 routes: conv1 "
                         f"{ell_routes['conv1']}, fc1000 "
                         f"{ell_routes['fc1000']}, {n_ell} ell")
    print("net resnet50 unstructured ELL layers (width, nnz): " + ", ".join(
        f"{n} ({aligned[n].ell_t.width}, {aligned[n].ell_t.nnz})"
        for n, r in ell_routes.items() if r == "ell") + f" {tag}")
    ell_params = params_to(aligned, dev, torch.bfloat16)
    ell_fwd = ell_net.inference_fn(ell_params, return_blobs=True)
    ell_dense = Net(fnet.specs, policy=ExecutionPolicy()).inference_fn(
        params_to(fparams, dev), return_blobs=True)
    for m in mods.values():
        m.reset_counts()
    ell_out = [ell_fwd(i) for i in at_inputs]
    torch.cuda.synchronize()
    ell_launches = {k: m.launches for k, m in mods.items()}
    print(f"net resnet50 unstructured launches over {N_INPUTS} forwards: "
          f"{ell_launches} (expected none: the ELL path runs no hand "
          f"kernel) {tag}")
    if any(ell_launches.values()):
        raise SystemExit("the ELL path launched a kernel")
    num = den = 0.0
    for inputs, out in zip(at_inputs, ell_out):
        logits = out["fc1000"].float()
        if (out["prob"].shape != (32, 1000)
                or not torch.isfinite(logits).all()
                or not torch.isfinite(out["prob"].float()).all()):
            raise SystemExit("unstructured resnet50 output is not finite "
                             "[32, 1000]")
        ref = ell_dense(inputs)["fc1000"]
        num += (logits - ref).pow(2).sum().item()
        den += ref.pow(2).sum().item()
    del ell_out
    rel_l2 = (num / den) ** 0.5
    ok = rel_l2 <= LOGITS_REL_L2
    print(f"net resnet50 unstructured fc1000 logits vs dense f32: rel L2 "
          f"{rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}) "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("unstructured resnet50 disagrees with dense f32")
    ell_ms = _time_ms(ell_fwd, at_inputs, iters=2 * N_INPUTS)
    per = _layer_split(ell_net.layers, ell_fwd, at_inputs[0])
    by_route = collections.Counter()
    for name, t in per.items():
        by_route[ell_routes.get(name, "other")] += t
    print(f"time resnet50 b32 unstructured ELL: eager {ell_ms:.3f} ms; "
          f"layers, device ms per forward, each layer alone as a CUDA "
          f"graph: sum {sum(per.values()):.3f}; by route "
          + ", ".join(f"{r} {t:.3f}" for r, t in by_route.most_common())
          + "; by layer " + ", ".join(
              f"{n} ({ell_routes.get(n, '-')}) {t:.4f}"
              for n, t in sorted(per.items(), key=lambda kv: -kv[1]))
          + f" {tag}")
    del ell_fwd, ell_params

    # ---- 5. times ---------------------------------------------------------
    for model, batch, layers, routes, arms, inputs, inputs_bf16 in e2e:
        ms = {arm: _time_ms(fn, inputs_bf16 if arm == "dense-bf16"
                            else inputs) for arm, fn in arms.items()}
        ms["sparse as a CUDA graph"] = _graph_ms(arms["sparse"], inputs,
                                                 N_INPUTS)
        print(f"time {model} b{batch}: " + ", ".join(
            f"{arm} {t:.3f} ms" for arm, t in ms.items()) + f" {tag}")
        per = _layer_split(layers, arms["sparse"], inputs[0])
        by_route = collections.Counter()
        for name, t in per.items():
            by_route[routes.get(name, "other")] += t
        top = sorted(per.items(), key=lambda kv: -kv[1])
        print(f"layers {model} sparse, device ms per forward, each layer "
              f"alone as a CUDA graph: sum {sum(per.values()):.3f}; by route "
              + ", ".join(f"{r} {t:.3f}" for r, t in by_route.most_common())
              + "; by layer " + ", ".join(
                  f"{n} ({routes.get(n, '-')}) {t:.4f}" for n, t in top)
              + f" {tag}")
    # host time of one entry call of each kernel on a tiny input, so each
    # launch's device work ends before the host has issued the next one;
    # the SpMM's splits K (4 shares), so its workspace is allocated too
    tiny = torch.randn((1, 8, 8, 64), generator=gen, device=dev).bfloat16()
    fused_w, gc_w = conv_weight(64, 64, 3), conv_weight(64, 128, 3)
    fc_w = dense_to_bsc(rng_np.standard_normal((512, 128)).astype("float32"),
                        BLOCK).to(dev, torch.bfloat16)
    probes = {  # name -> (what it is handed, one entry call)
        "sconv_fused": ("1x8x8x64 input", lambda: sconv_fused.sconv(
            tiny, fused_w, padding=(1, 1), relu=True)),
        "sconv_gc": ("1x8x8x64 input", lambda: sconv_gc.sconv(
            tiny, gc_w, padding=(1, 1), relu=True)),
        "bsc_spmm": ("8x512 A, 512x128 weight", lambda: bsc_spmm.bsc_spmm(
            tiny.reshape(8, 512), fc_w, relu=True)),
    }
    for name, (what, fn) in probes.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ROUTE_REPS):
            fn()
        host_us = (time.perf_counter() - t0) / ROUTE_REPS * 1e6
        torch.cuda.synchronize()
        print(f"host {name} entry: {host_us:.2f} us per call ({what}, "
              f"mean of {ROUTE_REPS}, host clock) {tag}")
    with torch.inference_mode():
        for kernel, label, arms, args, nbytes, flops in timed:
            graph = {arm: _graph_ms(fn, args) for arm, fn in arms.items()}
            eager = {arm: _time_ms(fn, args) for arm, fn in arms.items()}
            bound_ms, bound_by = _bound(nbytes, flops)
            r = results[kernel]
            for arm in ("kernel", "plain", "library"):
                key = "ms" if arm == "kernel" else f"{arm}_ms"
                r[key] += eager[arm]
                r["graph_" + key] += graph[arm]
            r["bound_ms"] += bound_ms
            # which limit sets the kernel's summed bound
            for k, v in (("bytes", nbytes), ("operations", flops)):
                r["bound"][k] += v / BOUND_RATES[k] * 1e3
            print(f"time {kernel} {label}, as a CUDA graph (eager): "
                  + ", ".join(f"{arm} {graph[arm]:.4f} ({eager[arm]:.4f}) ms"
                              for arm in arms)
                  + f"; bound {bound_ms * 1e3:.1f} us ({bound_by}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), kernel "
                  f"graph at {bound_ms / graph['kernel']:.1%} of it, "
                  f"{graph['kernel'] / graph['library']:.2f}x the library "
                  f"{tag}")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"caffe_escoin_tpu_torch/csrc/{k}.cu",
         "replaces": replaces, "launches": results[k]["launches"],
         "max_abs_err": results[k]["err"],
         **{key: results[k][key] for key in (
             "ms", "plain_ms", "bound_ms", "library_ms", "graph_ms",
             "graph_plain_ms", "graph_library_ms")},
         "bound_by": max(results[k]["bound"], key=results[k]["bound"].get)}
        for k, replaces in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
