#!/usr/bin/env python3
"""Repeat phase 4b of ``chip_smoke.py`` on the card: how often does the
autotuner's calibration of ResNet-50 b32 leave a slower arm in the net?

The net is phase 4's kernel-route ResNet-50 b32 (seed 0, 90% of its
weights pruned in 128x128 blocks, fused, aligned, bf16). Each run empties
the autotune table, calibrates the autotuned net as phase 4b does
(``calibrate_graph``, polish 8, under the net's scope, every arm of every
key measured with ``CESCOIN_AUTOTUNE_FUSED=1``), and then reads the two
forwards as CUDA graphs in the order kernel route, autotuned, autotuned,
kernel route (``chip_smoke._graph_ms``). One line per run: the ratio of
the means, the readings, the arms picked and every key not on ``fused``
with its measured arm times; then a summary line with the card's name and
power limit.

``--one-by-one`` times each key's arms one after another, as the JAX
module does (``device_time`` per arm), in place of
``utils/benchmark.device_time_arms``, which times them in turn; for the
run it replaces that function and restores it after. A measurement
script, not part of the package.

Run from the repository root on a machine with one CUDA device:
``python3 calib_repeat.py [--runs N] [--one-by-one]``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import statistics
import sys
import time

import torch

import chip_smoke as cs
from caffe_escoin_tpu_torch.engine import autotune
from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import _build
from caffe_escoin_tpu_torch.models import ZOO
from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
from caffe_escoin_tpu_torch.utils import benchmark

CACHE = "build/calib_repeat_autotune.json"


@contextlib.contextmanager
def arms_one_by_one():
    """``device_time_arms`` replaced by one ``device_time`` per arm."""
    in_turn = benchmark.device_time_arms

    def one_by_one(arms, arg_sets, *, iters=20):
        sets = list(arg_sets)
        return {name: benchmark.device_time(f, *sets[0], iters=iters,
                                            arg_sets=sets)
                for name, f in arms.items()}

    benchmark.device_time_arms = one_by_one
    try:
        yield
    finally:
        benchmark.device_time_arms = in_turn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--one-by-one", action="store_true",
                    help="time each key's arms one after another")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calib_repeat: no CUDA device", file=sys.stderr)
        return 1
    card = cs._card_line()
    tag = f"[{card}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.load()

    build, shapes = ZOO["resnet50"]
    shapes = {"data": (32,) + tuple(shapes["data"][1:])}
    pol_s = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=cs.BLOCK,
                            compute_dtype=torch.bfloat16, cast_back=False,
                            use_xla_sparse=False)
    net = Net(build(), policy=pol_s)
    params = net.init(torch.Generator().manual_seed(cs.SEED), shapes)
    fnet, fparams = fuse_inference(net, cs._prune(net, params),
                                   state=net.state0)
    sparse = params_to(fnet.weight_align(fparams), dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    xs = [torch.randn(shapes["data"], generator=gen, device=dev) * 0.1
          for _ in range(cs.N_INPUTS)]
    inputs = [{"data": x} for x in xs]
    fwd_s = fnet.inference_fn(sparse, return_blobs=True)

    os.environ["CESCOIN_AUTOTUNE_FUSED"] = "1"
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    at_net = Net(fnet.specs, policy=ExecutionPolicy(
        conv_mode=ConvMode.SCONV_PAR, block_shape=cs.BLOCK,
        compute_dtype=torch.bfloat16, cast_back=False, use_xla_sparse=True,
        autotune=True, autotune_cache=CACHE))
    at_fwd = at_net.inference_fn(sparse, return_blobs=True)

    def fwd_at(i):
        with autotune.net_scope("resnet50"):
            return at_fwd(i)

    def time_sparse():
        return benchmark.device_time(
            lambda y: fwd_at({"data": y})["prob"], xs[0],
            iters=cs.CALIB_REPS, arg_sets=[(x,) for x in xs])

    order = "one after another" if args.one_by_one else "in turn"
    ratios, off_fused = [], 0
    timing = arms_one_by_one() if args.one_by_one else contextlib.nullcontext()
    with timing:
        for run in range(args.runs):
            if os.path.exists(CACHE):
                os.remove(CACHE)
            autotune.clear()
            t0 = time.perf_counter()
            calib = autotune.calibrate_graph(
                time_sparse, polish=cs.CALIB_POLISH, net_tag="resnet50",
                cache_path=CACHE)
            wall = time.perf_counter() - t0
            readings = collections.defaultdict(list)
            for label, fn in (("kernel", fwd_s), ("autotuned", fwd_at),
                              ("autotuned", fwd_at), ("kernel", fwd_s)):
                readings[label].append(cs._graph_ms(fn, inputs, cs.N_INPUTS))
            ratio = (statistics.fmean(readings["autotuned"])
                     / statistics.fmean(readings["kernel"]))
            ratios.append(ratio)
            measured = autotune.report()
            others = {k: a for k, a in calib["arms"].items() if a != "fused"}
            off_fused += bool(others)
            print(f"run {run + 1} of {args.runs}, arms timed {order}: "
                  f"autotuned / kernel-route graph {ratio:.3f}; readings ms "
                  + "; ".join(f"{k} " + " ".join(f"{t:.3f}" for t in v)
                              for k, v in readings.items())
                  + f"; arms {dict(collections.Counter(calib['arms'].values()))}"
                  f"; calibration {wall:.1f} s wall {tag}", flush=True)
            for key, arm in others.items():
                print(f"  not fused: {key} -> {arm}: " + " ".join(
                    f"{a}={t * 1e6:.1f}us"
                    for a, t in sorted(measured.get(key, {}).items())),
                    flush=True)
    print(f"calib_repeat, arms timed {order}: ratios "
          + " ".join(f"{r:.3f}" for r in ratios)
          + f" (max {max(ratios):.3f}, limit "
          f"{cs.AUTOTUNED_GRAPH_LIMIT}); runs with a key not on fused: "
          f"{off_fused} of {args.runs} {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
