"""Multi-rank scaling benchmark: batch-sharded sparse inference throughput
(port of ``caffe_escoin_tpu/tools/scaling.py``).

Each device count n runs n ranks (parallel/launch.py: NCCL with one card
per rank, or gloo processes with ``--platform cpu``; one rank runs in this
process) and writes one JSON row in the JAX schema, with ``device`` added:
the card's name and power limit as nvidia-smi gives them, or "cpu". Modes:

* ``dp``: the net's sparse inference forward on each rank's chunk of the
  batch, weights whole on every rank, no collective in the forward
  (parallel/dp.make_dp_eval_step);
* ``halo``: one sparse conv with H split over n ranks (parallel/halo.py),
  strong scaling over a fixed map;
* ``tp``: one sparse conv with the BSC's block columns split over n ranks
  (parallel/tp.py).

Every time is ``utils.benchmark.device_time`` of the rank's forward (CUDA
events around CUDA-graph replays on the card, the host clock on the CPU),
the slowest rank's. CPU ranks share one host's cores, so their per-rank
rate there is a lower bound set by that sharing, not by the links. Rows
are appended to ``--out`` only when it is given; the JAX package's
``SCALING.jsonl`` is refused.

    python -m caffe_escoin_tpu_torch.tools.scaling --devices 1 \\
        --model resnet50 --platform cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from caffe_escoin_tpu_torch.utils.benchmark import device_label

# the JAX package's TPU record, which no run of the port may extend
JAX_RECORD = Path(__file__).resolve().parents[2] / "SCALING.jsonl"


def log(m):
    print(m, file=sys.stderr, flush=True)


def _slowest(seconds: float, dev: torch.device) -> float:
    """The largest of the ranks' times."""
    t = torch.tensor([seconds], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def prune_convs(net, params, sparsity: float, block=(128, 128)):
    """Every conv with KH*KW*Cin >= 64 pruned in blocks (the stem stays
    dense), as the JAX harness prunes."""
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    pruned = {}
    for layer in net.layers:
        name = layer.spec.name
        p = params.get(name)
        if p is None:
            continue
        if (layer.spec.type in ("Convolution", "ConvolutionReLU")
                and "w" in p):
            w = p["w"].numpy()
            if w.shape[0] * w.shape[1] * w.shape[2] >= 64:
                pruned[name] = dict(p, w=torch.from_numpy(
                    prune_conv_weight(w, sparsity, block)))
                continue
        pruned[name] = p
    return pruned


def _measure_rank(model, batch_per_dev, sparsity, iters, seed, policy,
                  platform):
    from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                       ExecutionPolicy)
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, params_to
    from caffe_escoin_tpu_torch.parallel import dp, mesh as mesh_lib
    from caffe_escoin_tpu_torch.utils.benchmark import (device_time,
                                                        force_platform)

    dev = force_platform(platform)
    mesh = mesh_lib.make_mesh(data=-1, model=1)
    n_dev = mesh_lib.axis_size(mesh, "data")
    if policy is None:  # the JAX harness's: the XBSP arms
        policy = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                                 block_shape=(128, 128))
    build, input_shapes = ZOO[model]
    net = Net(build(), policy=policy, phase="test")
    batch = batch_per_dev * n_dev
    shape = (batch,) + tuple(input_shapes["data"][1:])
    params = net.init(torch.Generator().manual_seed(seed), {"data": shape})
    net.state0 = params_to(net.state0, dev)  # BatchNorm's buffers
    aligned = net.weight_align(prune_convs(net, params, sparsity))
    # nnz-work per sample: over the aligned layers, nnz * output pixels
    nnz_work = 0.0
    for layer in net.layers:
        a = aligned.get(layer.spec.name)
        if a is not None and getattr(a, "stats", None) is not None:
            out_shape = net.blob_shapes[layer.spec.tops[0]]
            nnz_work += a.stats.nnz * np.prod(out_shape[1:-1])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         * 0.1).to(dev)
    local = dp.shard_batch(mesh, {"data": x})
    step = dp.make_dp_eval_step(net, mesh)
    weights = params_to(aligned, dev)
    t = _slowest(device_time(lambda b: step(weights, b)["prob"], local,
                             iters=iters), dev)
    nnz_per_s = nnz_work * batch / t
    return dict(devices=n_dev, batch=batch, batch_per_dev=batch_per_dev,
                time_s=round(t, 6), samples_per_s=round(batch / t, 2),
                gnnz_per_s=round(nnz_per_s / 1e9, 2),
                gnnz_per_s_per_dev=round(nnz_per_s / 1e9 / n_dev, 2),
                device=device_label(dev))


def measure(model: str, n_dev: int, batch_per_dev: int, sparsity: float,
            iters: int, seed: int = 0, *, platform: str = "auto",
            policy=None):
    """Batch-sharded sparse inference of ``model`` over ``n_dev`` ranks:
    the row of rank 0. ``policy`` is the net's ``ExecutionPolicy``; None
    is the JAX harness's (SCONV_PAR, 128x128 blocks, the XBSP arms)."""
    from caffe_escoin_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_measure_rank, n_dev, model, batch_per_dev, sparsity,
                     iters, seed, policy, platform,
                     platform=platform)[0]


def _halo_rank(sparsity, iters, seed, platform):
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
    from caffe_escoin_tpu_torch.parallel import halo, mesh as mesh_lib
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
    from caffe_escoin_tpu_torch.utils.benchmark import (device_time,
                                                        force_platform)
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    dev = force_platform(platform)
    mesh = mesh_lib.make_mesh(data=1, model=dist.get_world_size())
    n_dev = mesh_lib.axis_size(mesh, "model")
    # the XBSP dispatcher inside the partition, as the JAX harness runs it
    policy = ExecutionPolicy(block_shape=(16, 16))
    rng = np.random.default_rng(seed)
    cin, cout = 64, 64
    h = 16 * n_dev  # H divides the mesh
    w = 32
    wt = prune_conv_weight(
        rng.standard_normal((3, 3, cin, cout)).astype(np.float32), sparsity,
        (16, 16))
    aligned = weight_align(wt, rng.standard_normal(cout).astype(np.float32),
                           policy=policy)
    x = torch.from_numpy(
        rng.standard_normal((2, h, w, cin)).astype(np.float32)).to(dev)
    xl = halo.shard_rows(x, mesh)
    al = aligned.to(dev)
    t = _slowest(device_time(
        lambda y: halo.spatial_sconv2d(y, al, mesh=mesh, padding=(1, 1),
                                       policy=policy, engine="auto"),
        xl, iters=iters), dev)
    nnz_work = aligned.stats.nnz * h * w * 2
    return dict(devices=n_dev, mode="halo", engine="xbsp",
                time_s=round(t, 6),
                gnnz_per_s=round(nnz_work / t / 1e9, 3),
                gnnz_per_s_per_dev=round(nnz_work / t / 1e9 / n_dev, 3),
                device=device_label(dev))


def measure_halo(n_dev: int, sparsity: float, iters: int, seed: int = 0, *,
                 platform: str = "auto"):
    """One sparse 3x3 conv (64 -> 64, 16x16 blocks, 2 x 16n x 32 map) with
    H split over ``n_dev`` ranks: the row of rank 0."""
    from caffe_escoin_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_halo_rank, n_dev, sparsity, iters, seed, platform,
                     platform=platform)[0]


def _tp_rank(sparsity, iters, seed, platform):
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
    from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib, tp
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
    from caffe_escoin_tpu_torch.utils.benchmark import (device_time,
                                                        force_platform)
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    dev = force_platform(platform)
    mesh = mesh_lib.make_mesh(data=1, model=dist.get_world_size())
    n_dev = mesh_lib.axis_size(mesh, "model")
    policy = ExecutionPolicy(block_shape=(16, 8))
    rng = np.random.default_rng(seed)
    cin, cout = 32, 8 * 8 * n_dev  # bn=8, cout blocks divide the mesh
    wt = prune_conv_weight(
        rng.standard_normal((3, 3, cin, cout)).astype(np.float32), sparsity,
        (16, 8))
    aligned = weight_align(wt, rng.standard_normal(cout).astype(np.float32),
                           policy=policy)
    x = torch.from_numpy(
        rng.standard_normal((2, 16, 16, cin)).astype(np.float32)).to(dev)
    al = aligned.to(dev)
    t = _slowest(device_time(
        lambda y: tp.tp_conv_lowered(y, al, mesh=mesh, padding=(1, 1),
                                     policy=policy), x, iters=iters), dev)
    nnz_work = aligned.stats.nnz * 16 * 16 * 2
    return dict(devices=n_dev, mode="tp", time_s=round(t, 6),
                gnnz_per_s=round(nnz_work / t / 1e9, 3),
                gnnz_per_s_per_dev=round(nnz_work / t / 1e9 / n_dev, 3),
                device=device_label(dev))


def measure_tp(n_dev: int, sparsity: float, iters: int, seed: int = 0, *,
               platform: str = "auto"):
    """One sparse 3x3 conv (32 -> 64n, 16x8 blocks) with the block columns
    split over ``n_dev`` ranks: the row of rank 0."""
    from caffe_escoin_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_tp_rank, n_dev, sparsity, iters, seed, platform,
                     platform=platform)[0]


def main(argv=None):
    from caffe_escoin_tpu_torch.utils.benchmark import (PLATFORMS,
                                                        force_platform)

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--batch_per_dev", type=int, default=4)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--mode", default="dp", choices=["dp", "halo", "tp"])
    ap.add_argument("--platform", default="auto", choices=PLATFORMS)
    ap.add_argument("--out", default="",
                    help="append each row to this JSON-lines file")
    args = ap.parse_args(argv)
    if args.out and Path(args.out).resolve() == JAX_RECORD:
        print(f"error: {JAX_RECORD.name} is the JAX package's record; "
              f"write the port's rows elsewhere", file=sys.stderr)
        return 2
    try:
        dev = force_platform(args.platform)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    avail = (torch.cuda.device_count() if dev.type == "cuda"
             else os.cpu_count() or 1)
    counts = [int(c) for c in args.devices.split(",") if int(c) <= avail]
    log(f"platform {dev.type}, {avail} ranks available; measuring "
        f"{counts} ({args.mode})")
    rows = []
    for n in counts:
        if args.mode == "halo":
            r = measure_halo(n, args.sparsity, args.iters,
                             platform=args.platform)
        elif args.mode == "tp":
            r = measure_tp(n, args.sparsity, args.iters,
                           platform=args.platform)
        else:
            r = measure(args.model, n, args.batch_per_dev, args.sparsity,
                        args.iters, platform=args.platform)
        r["scaling_efficiency"] = (
            round(r["gnnz_per_s_per_dev"] / rows[0]["gnnz_per_s_per_dev"], 3)
            if rows else 1.0)
        r["model"] = args.model
        r["sparsity"] = args.sparsity
        r["backend"] = dev.type
        rows.append(r)
        sps = (f"{r['samples_per_s']:.1f} samples/s, "
               if "samples_per_s" in r else "")
        log(f"  {n} dev: {sps}{r['gnnz_per_s_per_dev']} Gnnz/s/dev, "
            f"eff {r['scaling_efficiency']:.0%} [{r['device']}]")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
