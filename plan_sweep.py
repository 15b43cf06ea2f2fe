#!/usr/bin/env python3
"""Sweep the launch plans of the pipelined tile loop on the card.

For each direct-conv layer shape below (ResNet-50 b32 and VGG-16 b16
layers, weights pruned to 90% in 128x128 blocks, bf16), ``sconv_fused``
runs with every (tile rows, ring stages) pair the kernel compiles, beside
the pair that ``caffe_escoin_tpu_torch/kernels/sconv_pipe.plan`` picks. For
each SpMM shape (ResNet-50's fc1000 at b32, VGG-16's fc6-8 at b16 and
conv1_2's lowered im2col GEMM), ``bsc_spmm`` runs with every (tile rows,
split of K, ring stages) the kernel takes, beside the pick of
``sconv_pipe.spmm_plan``. Each plan is timed as a CUDA graph of 20 calls
cycling 4 inputs. This is the measurement behind those rules. A
measurement script, not part of the package: for the sweep it replaces the
plan function with the forced plan and restores it after.

Run from the repository root on a machine with one CUDA device:
``python3 plan_sweep.py`` (both), ``python3 plan_sweep.py conv`` or
``python3 plan_sweep.py spmm``. One line per shape.
"""

from __future__ import annotations

import dataclasses
import itertools
import subprocess
import sys

import numpy as np
import torch

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_fused, sconv_pipe
from caffe_escoin_tpu_torch.sparse import dense_to_bsc
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
from caffe_escoin_tpu_torch.utils.pruning import prune_blocks, prune_conv_weight

# (label, batch, h = w, cin, cout, k, pad, residual)
SHAPES = [
    ("res2 56x56 64->64 3x3", 32, 56, 64, 64, 3, 1, False),
    ("res2 56x56 64->256 1x1 +res", 32, 56, 64, 256, 1, 0, True),
    ("res2 56x56 256->64 1x1", 32, 56, 256, 64, 1, 0, False),
    ("res3 28x28 128->128 3x3", 32, 28, 128, 128, 3, 1, False),
    ("res3 28x28 512->128 1x1", 32, 28, 512, 128, 1, 0, False),
    ("res4 14x14 256->256 3x3", 32, 14, 256, 256, 3, 1, False),
    ("res4 14x14 256->1024 1x1 +res", 32, 14, 256, 1024, 1, 0, True),
    ("res4 14x14 1024->256 1x1", 32, 14, 1024, 256, 1, 0, False),
    ("res5 7x7 512->512 3x3", 32, 7, 512, 512, 3, 1, False),
    ("res5 7x7 2048->512 1x1", 32, 7, 2048, 512, 1, 0, False),
    ("res5 7x7 512->2048 1x1 +res", 32, 7, 512, 2048, 1, 0, True),
    ("vgg conv3_1 56x56 128->256 3x3", 16, 56, 128, 256, 3, 1, False),
    ("vgg conv4_2 28x28 512->512 3x3", 16, 28, 512, 512, 3, 1, False),
    ("vgg conv5_2 14x14 512->512 3x3", 16, 14, 512, 512, 3, 1, False),
]
# (label, m, k, n, relu): the fc layers in 128x128 blocks; k = 0 marks
# conv1_2's lowered GEMM, [16*224*224, 9*64] against its 3x3 64->64 weight
SPMM_SHAPES = [
    ("fc1000 b32 32x2048->1000", 32, 2048, 1000, False),
    ("fc6 b16 16x25088->4096 +relu", 16, 25088, 4096, True),
    ("fc7 b16 16x4096->4096 +relu", 16, 4096, 4096, True),
    ("fc8 b16 16x4096->1000", 16, 4096, 1000, False),
    ("conv1_2 lowered b16 802816x576->64 +relu", 16 * 224 * 224, 0, 64,
     True),
]
ITERS = 20


def graph_ms(fn, args, iters=ITERS):
    """Mean device ms per call of ``iters`` calls captured in a CUDA graph."""
    for a in args:
        fn(a)
    torch.cuda.synchronize()
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
    return start.elapsed_time(end) / iters


def sweep_conv(dev, card):
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    policy = ExecutionPolicy(block_shape=(128, 128))
    picked = sconv_pipe.plan
    try:
        for label, b, h, cin, cout, k, pad, with_res in SHAPES:
            w = prune_conv_weight(
                rng.standard_normal((k, k, cin, cout)).astype(np.float32),
                0.9, (min(128, cin), 128))
            al = weight_align(w, rng.standard_normal(cout).astype(np.float32),
                              policy=policy).to(dev, torch.bfloat16)
            xs = [torch.randn((b, h, h, cin), generator=gen, device=dev
                              ).bfloat16() for _ in range(4)]
            res = (torch.randn((b, h, h, cout), generator=gen, device=dev
                               ).bfloat16() if with_res else None)
            plan = sconv_fused.launch_plan(xs[0].shape, al, (pad, pad))
            bn_t = sconv_pipe.bn_tile(al.bsc.block_shape[1])
            times = []
            for tile_m, stages in itertools.product((64, 128), (2, 3, 4)):
                forced = dataclasses.replace(
                    plan, tile_m=tile_m, stages=stages,
                    smem=sconv_pipe.smem_bytes(tile_m, bn_t, stages))
                sconv_pipe.plan = lambda *a, p=forced: p
                sconv_fused._c_dims.cache_clear()
                ms = graph_ms(lambda x: sconv_fused.sconv(
                    x, al, padding=(pad, pad), relu=True, residual=res), xs)
                times.append(f"({tile_m},{stages}) {ms * 1e3:.1f}")
            sconv_pipe.plan = picked
            sconv_fused._c_dims.cache_clear()
            print(f"{label}: picked ({plan.tile_m},{plan.stages}), max_bw "
                  f"{al.bsc.max_bw}; us per call as (tile rows, stages): "
                  + ", ".join(times) + f" [{card}]", flush=True)
    finally:
        sconv_pipe.plan = picked
        sconv_fused._c_dims.cache_clear()


def _spmm_splits(max_bw, cpb):
    """Every split of K the kernel takes for a column of ``max_bw`` live
    K-blocks: one per distinct share size, each share >= 2 ring steps."""
    out = {}
    for share in range(1, max_bw + 1):
        if share * cpb >= 2 or share == max_bw:
            out.setdefault(-(-max_bw // share), share)
    return sorted(out.items())


def sweep_spmm(dev, card):
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    picked = sconv_pipe.spmm_plan
    try:
        for label, m, k, n, relu in SPMM_SHAPES:
            if k:
                bsc = dense_to_bsc(prune_blocks(
                    rng.standard_normal((k, n)).astype(np.float32)
                    * (3.0 / k) ** 0.5, 0.9, (128, 128)), (128, 128))
            else:
                w = prune_conv_weight(rng.standard_normal(
                    (3, 3, 64, 64)).astype(np.float32) * (2.0 / 576) ** 0.5,
                    0.9, (64, 128))
                bsc = weight_align(w, policy=ExecutionPolicy(
                    block_shape=(128, 128))).bsc
            bsc = bsc.to(dev, torch.bfloat16)
            bias = torch.randn(n, generator=gen, device=dev) * 0.1
            xs = [torch.randn((m, bsc.shape[0]), generator=gen, device=dev
                              ).bfloat16() for _ in range(4)]
            plan = bsc_spmm.launch_plan(m, bsc)
            bk, bn = bsc.block_shape
            bn_t = sconv_pipe.bn_tile(bn)
            cpb = -(-bk // sconv_pipe.CHUNK)
            times = {}
            for tile_m in (64, 128):
                splits = _spmm_splits(bsc.max_bw, cpb) if tile_m == 64 \
                    else [(1, bsc.max_bw)]
                for (split, share), stages in itertools.product(
                        splits, (2, 3, 4)):
                    forced = dataclasses.replace(
                        plan, tile_m=tile_m, stages=stages, split=split,
                        share=share if split > 1 else 0,
                        smem=sconv_pipe.smem_bytes(tile_m, bn_t, stages))
                    sconv_pipe.spmm_plan = lambda *a, p=forced: p
                    bsc_spmm._launch.cache_clear()
                    times[(tile_m, split, stages)] = graph_ms(
                        lambda a: bsc_spmm.bsc_spmm(a, bsc, bias=bias,
                                                    relu=relu), xs)
            sconv_pipe.spmm_plan = picked
            bsc_spmm._launch.cache_clear()
            best = min(times, key=times.get)
            pick = (plan.tile_m, plan.split, plan.stages)
            print(f"{label}: picked {pick} {times[pick] * 1e3:.1f} us, "
                  f"fastest {best} {times[best] * 1e3:.1f} us; max_bw "
                  f"{bsc.max_bw}; us per call as (tile rows, split, "
                  "stages): " + ", ".join(
                      f"{key} {t * 1e3:.1f}" for key, t in times.items())
                  + f" [{card}]", flush=True)
    finally:
        sconv_pipe.spmm_plan = picked
        bsc_spmm._launch.cache_clear()


def main() -> int:
    which = sys.argv[1:] or ["conv", "spmm"]
    if not torch.cuda.is_available():
        print("plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", torch.cuda.current_device())
    if "conv" in which:
        sweep_conv(dev, card)
    if "spmm" in which:
        sweep_spmm(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
