#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (caffe_escoin_tpu_torch) on one GPU.

Drives the port's two inference paths the way ``bench.py``'s ``run_e2e``
composes them (without autotune, calibration, packing or buckets):

* ResNet-50 at batch 32, 224x224, conv and fc weights pruned to 90% in
  128x128 blocks (the 3-channel stem stays dense), BatchNorm/Scale/ReLU/
  residual fused into the convs;
* VGG-16 at batch 16, 224x224, full width, the same pruning (each pruned
  weight scaled back to its norm, so that the signal survives thirteen
  pruned convs and three pruned fcs), fc6/fc7 ReLU fused, Dropout kept as
  the inference identity;

both weight-aligned to BSC and run in SCONV_PAR mode in bf16 on the card.

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
  4. nets, each on 4 distinct inputs with every launch counter set to 0
     just before and read just after: every kernel must have launched as
     many times as the layers' routes (``Net.routes``, the function the
     dispatch runs through) say; the last classifier's logits within 5e-2
     relative L2 of the same pruned, fused net run dense in f32 (cuDNN,
     TF32 off). Also the routing's host time per layer (``Net.routes``,
     host clock).
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
``graph_plain_ms`` and ``graph_library_ms`` the same as CUDA graphs. As
the last line {"ok": true, "device": {...}}.

Run from the repository root: ``python3 chip_smoke.py``. Needs one CUDA
device and nvcc; exits 1 without them.
"""

from __future__ import annotations

import collections
import json
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


def _prune(net, params, keep_norm=False):
    """bench.py's pruning: conv and fc weights at SPARSITY in BLOCK blocks.
    The stem (3 input channels) stays dense. ``keep_norm`` scales each
    pruned weight back to its Frobenius norm, which bench.py does not: it
    keeps the signal alive through VGG-16's sixteen pruned layers."""
    import torch

    from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,
                                                      prune_conv_weight)

    out = dict(params)
    for layer in net.layers:
        name, kind = layer.spec.name, layer.spec.type
        if name not in out or kind not in ("Convolution", "ConvolutionReLU",
                                           "InnerProduct"):
            continue
        q = dict(out[name])
        w = q["w"].numpy()
        if kind == "InnerProduct":
            wp = prune_blocks(w, SPARSITY, BLOCK)
        elif w.shape[2] >= 32:
            wp = prune_conv_weight(w, SPARSITY, BLOCK)
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
        from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                           ExecutionPolicy)
        from caffe_escoin_tpu_torch.kernels import (_build, bsc_spmm,
                                                    sconv_fused, sconv_gc)
        from caffe_escoin_tpu_torch.models import ZOO
        from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
        from caffe_escoin_tpu_torch.nn.layers import ROUTE_KERNELS
        from caffe_escoin_tpu_torch.sparse import dense_to_bsc
        from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
        from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,
                                                          prune_conv_weight)
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
            raise SystemExit(f"{kernel} {label}: kernel disagrees with plain")
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

    # ---- 4. the nets ------------------------------------------------------
    pol_s = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                            compute_dtype=torch.bfloat16, cast_back=False)
    e2e = []  # (model, batch, {arm: fn}, inputs f32, inputs bf16)
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
        e2e.append((model, batch, fnet.layers, routes,
                    {"sparse": fwd_s, "dense-bf16": fwd_db,
                     "dense-f32": fwd_d},
                    [{"data": x} for x in xs],
                    [{"data": x.bfloat16()} for x in xs]))
        del sparse_out

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
