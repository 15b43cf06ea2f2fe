"""A/B of four max-pool formulations on the card (port of
``scripts/exp_pool_r5.py``), on its six hot shapes in bf16:

* ``rw``: the max-pool kernel's plain version
  (``kernels/maxpool.max_pool_plain``: pad with -inf, ``F.max_pool2d`` on a
  channels-first view, crop), the counterpart of ``lax.reduce_window``;
* ``slice9``: the max of kh*kw shifted strided slices of the padded input;
* ``twopass``: the 1-D W-max (stride sw), then the 1-D H-max (stride sh);
* ``hand``: the port's own max-pool path, ``ops/pool.pool2d``: the hand
  kernel ``csrc/maxpool.cu`` on the card (the plain version on the CPU).

The four must give the same tensor (``torch.equal``, as the script
asserts ``np.array_equal``). Each is timed by ``device_time`` over
CUDA-graph replays cycling 4 inputs; one ``pool_ab`` row per shape with
``t_<name>_us``.

    python -m caffe_escoin_tpu_torch.experiments.pool [--platform cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.experiments import common
from caffe_escoin_tpu_torch.kernels.maxpool import max_pool_plain
from caffe_escoin_tpu_torch.ops.pool import _pooled_size, pool2d
from caffe_escoin_tpu_torch.utils.benchmark import device_time

SHAPES = [
    # (shape, k, s, p, tag)
    ((16, 28, 28, 192), 3, 1, 1, "gln_3a_poolbranch"),
    ((16, 56, 56, 192), 3, 2, 0, "gln_pool2"),
    ((16, 112, 112, 64), 3, 2, 0, "gln_pool1"),
    ((32, 112, 112, 64), 3, 2, 1, "rn50_pool1_b32"),
    ((16, 14, 14, 512), 3, 1, 1, "gln_4b_poolbranch"),
    ((32, 28, 28, 96), 3, 2, 0, "alexnet_pool1ish"),
]
ITERS = 20


def _padded(x, k, s, p):
    """(x padded with -inf to cover every ceil-sized window, ho, wo)."""
    ho = _pooled_size(x.shape[1], k, s, p, True)
    wo = _pooled_size(x.shape[2], k, s, p, True)
    pad2 = max(0, (ho - 1) * s + k - x.shape[1] - p)
    return F.pad(x, (0, 0, p, pad2, p, pad2), value=float("-inf")), ho, wo


def pool_rw(x, k, s, p):
    ho = _pooled_size(x.shape[1], k, s, p, True)
    wo = _pooled_size(x.shape[2], k, s, p, True)
    return max_pool_plain(x, (k, k), (s, s), (p, p), (ho, wo))


def pool_slice9(x, k, s, p):
    xp, ho, wo = _padded(x, k, s, p)
    out = None
    for i in range(k):
        for j in range(k):
            sl = xp[:, i:i + (ho - 1) * s + 1:s, j:j + (wo - 1) * s + 1:s, :]
            out = sl if out is None else torch.maximum(out, sl)
    return out.contiguous()


def pool_twopass(x, k, s, p):
    xp, ho, wo = _padded(x, k, s, p)
    m = None
    for j in range(k):
        sl = xp[:, :, j:j + (wo - 1) * s + 1:s, :]
        m = sl if m is None else torch.maximum(m, sl)
    out = None
    for i in range(k):
        sl = m[:, i:i + (ho - 1) * s + 1:s, :, :]
        out = sl if out is None else torch.maximum(out, sl)
    return out.contiguous()


def pool_hand(x, k, s, p):
    return pool2d(x, (k, k), stride=(s, s), padding=(p, p), mode="max")


CANDIDATES = (("rw", pool_rw), ("slice9", pool_slice9),
              ("twopass", pool_twopass), ("hand", pool_hand))


def run(device, emit, *, shapes=SHAPES, iters=ITERS):
    """One ``pool_ab`` row per shape; raises AssertionError where a
    candidate's output is not the others'."""
    rng = np.random.default_rng(0)
    rows = []
    for shape, k, s, p, tag in shapes:
        xs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                               ).to(device, torch.bfloat16) for _ in range(4)]
        row = {"kind": "pool_ab", "tag": tag, "shape": list(shape), "k": k,
               "s": s, "p": p}
        ref = None
        for name, fn in CANDIDATES:
            def f(x, fn=fn):
                return fn(x, k, s, p)

            y = f(xs[0])
            if ref is None:
                ref = y
            elif not torch.equal(ref, y):
                raise AssertionError(f"pool {tag}: {name} differs from rw")
            t = device_time(f, xs[0], iters=iters,
                            arg_sets=[(x,) for x in xs])
            row[f"t_{name}_us"] = round(t * 1e6, 2)
        rows.append(emit(**row))
    return rows


def main(argv=None) -> int:
    args = common.parser("pool", __doc__).parse_args(argv)
    device = common.device_of(args.platform)
    if device is None:
        return 2
    run(device, common.Rows(args.out, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
