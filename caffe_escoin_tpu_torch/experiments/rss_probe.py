"""Where a long training loop's host memory goes (port of
``scripts/rss_probe.py``), on one device-resident batch (the data
pipeline excluded):

  --variant train          ``engine/solver.Solver.step``, as ``cli train``
                           runs it
  --variant train_nofetch  the same step (``Solver._step``) without the
                           host read of the loss
  --variant forward        the loss forward alone, in inference mode
  --variant train_lenet    ``train`` on LeNet (does growth scale with the
                           model?)

Prints one JSON row at the start and one every ``--every`` iterations:
VmRSS in MB and, on the card, ``torch.cuda.memory_allocated()`` beside it.

    python -m caffe_escoin_tpu_torch.experiments.rss_probe [--variant ...]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from caffe_escoin_tpu_torch.experiments import common

VARIANTS = ("train", "train_nofetch", "forward", "train_lenet")


def rss_mb() -> int:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) // 1024
    return -1


def run(device, emit, *, variant="train", iters=3000, every=200, batch=64,
        model="alexnet"):
    """The rows of one probe; returns them."""
    from caffe_escoin_tpu_torch.engine.solver import Solver
    from caffe_escoin_tpu_torch.engine.solvers import SolverConfig
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net

    model = "lenet" if variant == "train_lenet" else model
    builder, ish = ZOO[model]
    try:
        specs = builder(num_classes=10, include_loss=True)
    except TypeError:
        specs = builder(include_loss=True)
    size, ch = ish["data"][1], ish["data"][3]
    net = Net(specs, phase="train")
    sol = Solver(net, SolverConfig(base_lr=0.01, momentum=0.9), display=0,
                 device=device)
    sol.init({"data": (batch, size, size, ch), "label": (batch,)})
    rng = np.random.default_rng(0)
    data = {"data": torch.from_numpy(rng.standard_normal(
        (batch, size, size, ch)).astype(np.float32) * 0.1).to(device),
        "label": torch.from_numpy(rng.integers(0, 10, batch)).to(device)}
    cuda = device.type == "cuda"

    def row(**kw):
        if cuda:
            torch.cuda.synchronize(device)
            kw["cuda_allocated_mb"] = round(
                torch.cuda.memory_allocated(device) / 2**20, 1)
        return emit(variant=variant, model=model, batch=batch, **kw)

    def batches():
        while True:
            yield data

    rows = [row(iter=0, rss_mb_start=rss_mb(), rss_mb=rss_mb())]
    t0 = time.perf_counter()
    done = 0
    if variant == "forward":
        with torch.inference_mode():
            while done < iters:
                n = min(every, iters - done)
                for _ in range(n):
                    net.loss(sol.params, data, train=False)
                done += n
                rows.append(row(iter=done, rss_mb=rss_mb(),
                                s=round(time.perf_counter() - t0, 2)))
        return rows
    src = batches()
    while done < iters:
        n = min(every, iters - done)
        if variant == "train_nofetch":
            # Solver.step's loop without float(loss): lr fixed at base_lr
            # (the policy's "fixed")
            for _ in range(n):
                sol._step([next(src)], sol.cfg.base_lr, sol.iter + 1)
                sol.iter += 1
        else:
            sol.step(src, n, log=lambda *_: None)
        done += n
        rows.append(row(iter=done, rss_mb=rss_mb(),
                        s=round(time.perf_counter() - t0, 2)))
    return rows


def main(argv=None) -> int:
    ap = common.parser("rss_probe", __doc__)
    ap.add_argument("--variant", default="train", choices=VARIANTS)
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--every", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--model", default="alexnet")
    args = ap.parse_args(argv)
    device = common.device_of(args.platform)
    if device is None:
        return 2
    run(device, common.Rows(args.out, device), variant=args.variant,
        iters=args.iters, every=args.every, batch=args.batch,
        model=args.model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
