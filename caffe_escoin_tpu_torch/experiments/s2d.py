"""A/B of the space-to-depth stem fold (``ops/s2d.py``) against the stock
strided conv (port of ``scripts/exp_s2d_r5.py``), for three stems:

  gln_conv1_b16      GoogLeNet conv1/7x7_s2, b16 224x224x3 -> 112x112x64
  rn50_conv1_b32     ResNet-50 conv1 7x7/s2, b32
  alexnet_conv1_b32  AlexNet conv1 11x11/s4, b32 227x227x3 -> 55x55x96

Each variant is the deployed stem: input cast to bf16 + conv + bias +
ReLU. The fold's input is ``ops/s2d.s2d_input``, which crops the grid's far
end where the strided conv drops input rows (the JAX package pads it by
max(0, ...)). Each is timed by ``device_time`` over CUDA-graph replays
cycling 4 inputs; ``rel_err`` (max abs difference over max|stock|) must be
within ``REL_TOL``.

    python -m caffe_escoin_tpu_torch.experiments.s2d [--platform cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from caffe_escoin_tpu_torch.experiments import common
from caffe_escoin_tpu_torch.ops import s2d
from caffe_escoin_tpu_torch.ops.conv import conv2d_dense
from caffe_escoin_tpu_torch.utils.benchmark import device_time

CASES = [
    ("gln_conv1_b16", (16, 224, 224, 3), 64, 7, 2, 3),
    ("rn50_conv1_b32", (32, 224, 224, 3), 64, 7, 2, 3),
    ("alexnet_conv1_b32", (32, 227, 227, 3), 96, 11, 4, 0),
]
ITERS = 20
# both variants end in one bf16 rounding of nearly equal f32 sums: at most
# one bf16 step (2^-8 of a value) apart, plus the sums' order
REL_TOL = 1e-2


def stems(w, b, r, p, device):
    """(stock, folded): the two stem callables of an f32 input."""
    k = w.shape[0]
    wj = torch.from_numpy(w).to(device, torch.bfloat16)
    wpj = torch.from_numpy(s2d.s2d_weight(w, r, (p, p))).to(device,
                                                            torch.bfloat16)
    bj = torch.from_numpy(b).to(device, torch.bfloat16)

    def stock(x):
        return conv2d_dense(x.to(torch.bfloat16), wj, bj, stride=(r, r),
                            padding=(p, p), relu=True)

    def folded(x):
        xp = s2d.s2d_input(x.to(torch.bfloat16), r, (k, k), (p, p))
        return conv2d_dense(xp, wpj, bj, relu=True)

    return stock, folded


def run(device, emit, *, cases=CASES, iters=ITERS):
    """One ``s2d_ab`` row per stem; raises AssertionError where the fold
    is off by more than ``REL_TOL``."""
    rng = np.random.default_rng(0)
    rows = []
    for tag, ishape, cout, k, r, p in cases:
        w = rng.standard_normal((k, k, ishape[-1], cout)).astype(np.float32)
        b = rng.standard_normal((cout,)).astype(np.float32) * 0.1
        xs = [torch.from_numpy(rng.standard_normal(ishape).astype(
            np.float32)).to(device) for _ in range(4)]
        stock, folded = stems(w, b, r, p, device)
        y0, y1 = stock(xs[0]).float(), folded(xs[0]).float()
        if y0.shape != y1.shape:
            raise AssertionError(f"s2d {tag}: {tuple(y1.shape)} against "
                                 f"{tuple(y0.shape)}")
        err = ((y0 - y1).abs().max() / (y0.abs().max() + 1e-9)).item()
        if not err <= REL_TOL:
            raise AssertionError(f"s2d {tag}: rel_err {err} > {REL_TOL}")
        sets = [(x,) for x in xs]
        t0 = device_time(stock, xs[0], iters=iters, arg_sets=sets)
        t1 = device_time(folded, xs[0], iters=iters, arg_sets=sets)
        rows.append(emit(kind="s2d_ab", tag=tag, k=k, s=r, p=p,
                         t_stock_us=round(t0 * 1e6, 2),
                         t_s2d_us=round(t1 * 1e6, 2),
                         speedup=round(t0 / t1, 3), rel_err=round(err, 6)))
    return rows


def main(argv=None) -> int:
    args = common.parser("s2d", __doc__).parse_args(argv)
    device = common.device_of(args.platform)
    if device is None:
        return 2
    run(device, common.Rows(args.out, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
