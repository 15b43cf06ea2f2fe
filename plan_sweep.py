#!/usr/bin/env python3
"""Sweep the direct convs' launch plan on the card.

For each layer shape below (ResNet-50 b32 and VGG-16 b16 layers, weights
pruned to 90% in 128x128 blocks, bf16), ``sconv_fused`` runs with every
(tile rows, ring stages) pair the kernel compiles, each timed as a CUDA
graph of 20 calls cycling 4 inputs, beside the pair that
``caffe_escoin_tpu_torch/kernels/sconv_pipe.plan`` picks. This is the
measurement behind that rule. A measurement script, not part of the
package: for the sweep it replaces ``sconv_pipe.plan`` with the forced
plan and restores it after.

Run from the repository root on a machine with one CUDA device:
``python3 plan_sweep.py``. One line per shape.
"""

from __future__ import annotations

import dataclasses
import itertools
import subprocess
import sys

import numpy as np
import torch

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import sconv_fused, sconv_pipe
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

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


def main() -> int:
    if not torch.cuda.is_available():
        print("plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", torch.cuda.current_device())
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
