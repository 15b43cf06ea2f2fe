"""The multi-rank dry run (port of ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` starts n ranks (parallel/launch.py: gloo processes
on the CPU, NCCL with n <= the number of cards) and runs, on tiny shapes,
step for step what the JAX function runs on an n-device mesh:

* one data-parallel training step of cifar10_quick (parallel/dp.py);
* a batch-sharded sparse conv on the XBSP arms;
* the GSPMD-style tensor-parallel forward of cifar10_quick
  (parallel/tp.forward_sharded), held to the whole forward;
* with a model axis above 1 (n even): a sparse conv with H split over the
  model axis (parallel/halo.py) and one with its block columns split
  (parallel/tp.tp_conv_lowered);
* the fused, W-pair packed, block-sparse ResNet-50 inference forward at
  224x224, batch-sharded, one image per rank.

    python -m caffe_escoin_tpu_torch.parallel.dryrun 2 --platform cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _dryrun_rank(n_devices: int, platform: str):
    import torch.distributed as dist

    from caffe_escoin_tpu_torch.engine import solvers
    from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                       ExecutionPolicy)
    from caffe_escoin_tpu_torch.kernels import xla_block_sparse
    from caffe_escoin_tpu_torch.models import cifar, resnet
    from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
    from caffe_escoin_tpu_torch.nn.fuse import pack_narrow_chains
    from caffe_escoin_tpu_torch.ops import conv as conv_ops
    from caffe_escoin_tpu_torch.parallel import dp, halo, mesh as mesh_lib, tp
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
    from caffe_escoin_tpu_torch.tools.scaling import prune_convs
    from caffe_escoin_tpu_torch.utils.benchmark import force_platform
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    dev = force_platform(platform)
    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) in a world of "
                           f"{dist.get_world_size()}")
    model_axis = 2 if n_devices % 2 == 0 else 1
    mesh = mesh_lib.make_mesh(data=n_devices // model_axis, model=model_axis)

    # --- DP training step (batch sharded, params replicated, grads
    # averaged) ---
    net = Net(cifar.cifar10_quick(include_loss=True), phase="train",
              device=dev)
    batch_n = 2 * n_devices
    params = net.init(torch.Generator().manual_seed(0),
                      {"data": (batch_n, 32, 32, 3), "label": (batch_n,)})
    cfg = solvers.SolverConfig(solver_type="sgd", base_lr=0.01, momentum=0.9,
                               weight_decay=1e-4)
    p = dp.replicate_params(mesh, params_to(params, dev))
    s = solvers.init_state(cfg, p)
    step = dp.make_dp_train_step(net, cfg, mesh)
    batch = dp.shard_batch(mesh, {
        "data": torch.ones((batch_n, 32, 32, 3), device=dev),
        "label": torch.zeros((batch_n,), dtype=torch.int64, device=dev)})
    _, _, _, loss = step(p, s, {}, batch, 0.01, 1,
                         torch.Generator(device=dev).manual_seed(1))
    loss = float(loss)

    # --- batch-sharded sparse inference on the XBSP arms: weights whole on
    # every rank, the batch split over all ranks, no collective ---
    rng0 = np.random.default_rng(7)
    sp_policy = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                                block_shape=(16, 16))
    w_sp = prune_conv_weight(
        rng0.standard_normal((3, 3, 16, 32)).astype(np.float32), 0.8,
        (16, 16))
    al_sp = weight_align(w_sp, None, policy=sp_policy)
    if not xla_block_sparse.supported(al_sp, sp_policy):
        raise RuntimeError("the XBSP arms do not take the dry run's conv")
    dmesh = mesh_lib.make_mesh(data=n_devices, model=1)
    xs = dp.shard_batch(dmesh, {"data": torch.from_numpy(
        rng0.standard_normal((2 * n_devices, 8, 8, 16)).astype(
            np.float32)).to(dev)})["data"]
    with torch.inference_mode():
        conv_ops.conv2d(xs, al_sp.to(dev), padding=(1, 1), policy=sp_policy)

    # --- TP (cout-sharded weights) forward over the same mesh ---
    infer_net = Net(cifar.cifar10_quick(), phase="test")
    iparams = params_to(infer_net.init(torch.Generator().manual_seed(0),
                                       {"data": (4, 32, 32, 3)}), dev)
    shardings = tp.param_shardings(iparams, mesh)
    local = tp.local_params(iparams, shardings, mesh)
    xi = {"data": torch.ones((4, 32, 32, 3), device=dev)}
    out = tp.forward_sharded(infer_net, local, xi, mesh)["prob"]
    with torch.inference_mode():
        whole = infer_net.apply(iparams, xi)["prob"]
    if not torch.allclose(out, whole, rtol=1e-4, atol=1e-5):
        raise RuntimeError("the tensor-parallel forward differs from the "
                           "whole forward")

    if model_axis > 1:
        # --- spatial partitioning (halo exchange) of a sparse conv ---
        policy = ExecutionPolicy(block_shape=(16, 16))
        rng = np.random.default_rng(0)
        w = prune_conv_weight(
            rng.standard_normal((3, 3, 16, 32)).astype(np.float32), 0.8,
            (16, 16))
        aligned = weight_align(w, rng.standard_normal(32).astype(np.float32),
                               policy=policy).to(dev)
        x = torch.from_numpy(rng.standard_normal(
            (2, 8 * model_axis, 8, 16)).astype(np.float32)).to(dev)
        with torch.inference_mode():
            halo.spatial_sconv2d(halo.shard_rows(x, mesh), aligned,
                                 mesh=mesh, padding=(1, 1), policy=policy)

        # --- cout-block-partitioned sparse SpMM ---
        w2 = prune_conv_weight(
            rng.standard_normal((3, 3, 16, 64)).astype(np.float32), 0.8,
            (16, 8))
        policy2 = ExecutionPolicy(block_shape=(16, 8))
        aligned2 = weight_align(w2, None, policy=policy2).to(dev)
        with torch.inference_mode():
            tp.tp_conv_lowered(
                torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(
                    np.float32)).to(dev),
                aligned2, mesh=mesh, padding=(1, 1), policy=policy2)

    # --- the fused + W-packed block-sparse ResNet-50 inference graph,
    # batch-sharded over every rank ---
    rpol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                           block_shape=(128, 128),
                           compute_dtype=torch.bfloat16, cast_back=False)
    rnet = Net(resnet.resnet50(num_classes=1000), policy=rpol, phase="test")
    rparams = rnet.init(torch.Generator().manual_seed(0),
                        {"data": (n_devices, 224, 224, 3)})
    rfnet, rfparams = fuse_inference(rnet, prune_convs(rnet, rparams, 0.9),
                                     state=rnet.state0)
    rfnet = pack_narrow_chains(rfnet)
    raligned = params_to(rfnet.weight_align(rfparams), dev)
    rx = dp.shard_batch(dmesh, {"data": torch.zeros(
        (n_devices, 224, 224, 3), device=dev)})
    rout = rfnet.inference_fn(raligned)(rx)["prob"]
    if not torch.isfinite(rout.float()).all():
        raise RuntimeError("the ResNet-50 forward is not finite")
    return dict(mesh={"data": n_devices // model_axis, "model": model_axis},
                loss=loss, n_packed=len(getattr(rfnet, "packed_blobs", {})))


def dryrun_multichip(n_devices: int, *, platform: str = "auto") -> None:
    """Run the dry run on ``n_devices`` ranks and print the JAX function's
    line; any rank's failure raises."""
    from caffe_escoin_tpu_torch.parallel.launch import run_ranks

    r = run_ranks(_dryrun_rank, n_devices, n_devices, platform,
                  platform=platform)[0]
    print(f"dryrun_multichip({n_devices}): OK "
          f"(mesh {r['mesh']}, loss={r['loss']:.4f}, "
          f"resnet50 fused+packed[{r['n_packed']}] sharded forward ok)")


def main(argv=None) -> int:
    from caffe_escoin_tpu_torch.utils.benchmark import PLATFORMS

    ap = argparse.ArgumentParser()
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--platform", default="auto", choices=PLATFORMS)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, platform=args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
