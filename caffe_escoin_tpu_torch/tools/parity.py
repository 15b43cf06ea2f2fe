"""Accuracy-parity harness: sparse modes against the dense forward on the
same net (port of ``caffe_escoin_tpu/tools/parity.py``).

The reference validated sparse kernels end-to-end by eyeballing top-1/top-5
of `caffe test` runs against dense (`run.sh:3-20`, SURVEY.md section 4) —
no tolerances. This tool makes that check quantitative: for each sparse
conv mode (LOWERED_SPARSE, SCONV, SCONV_PAR) it reports max |prob diff|,
top-1 agreement and top-5 overlap against LOWERED_GEMM on the same pruned
weights, and exits 1 when a mode's max |prob diff| exceeds ``--tol``.

  python -m caffe_escoin_tpu_torch.tools.parity --model resnet50 \\
      --sparsity 0.9 --batches 4 --platform cpu
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from caffe_escoin_tpu_torch.utils.benchmark import (PLATFORMS,
                                                        force_platform)

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lenet")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--block-shape", type=int, nargs=2, default=[128, 128])
    ap.add_argument("--platform", default="auto", choices=PLATFORMS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="max allowed |prob diff| (f32 accumulation-order "
                         "tolerance; reference defined none)")
    ap.add_argument("--weights", default="",
                    help="trained weights: a checkpoint (.npz prefix) or a "
                         ".caffemodel — parity on REAL weights instead of "
                         "random init (pass --sparsity 0 if the checkpoint "
                         "is already pruned)")
    ap.add_argument("--fuse", action="store_true",
                    help="apply inference graph fusion (BN/Scale fold + "
                         "ReLU/residual epilogues) to every arm before "
                         "comparing — checks the deployed graph")
    args = ap.parse_args(argv)
    try:
        dev = force_platform(args.platform)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                       ExecutionPolicy)
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, params_to
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    builder, input_shapes = ZOO[args.model]
    data_shape = (args.batch,) + tuple(input_shapes["data"][1:])
    rng = np.random.default_rng(args.seed)

    def make_net(mode):
        policy = ExecutionPolicy(conv_mode=mode,
                                 block_shape=tuple(args.block_shape))
        return Net(builder(num_classes=args.num_classes), policy=policy)

    base_net = make_net(ConvMode.LOWERED_GEMM)
    params = base_net.init(torch.Generator().manual_seed(args.seed),
                           {"data": data_shape})
    state = {k: dict(v) for k, v in base_net.state0.items()}

    # trained weights: real-model parity instead of random init (the
    # check the reference ran as `caffe test` dense-vs-sparse, run.sh:3-20)
    if args.weights and args.weights.endswith(".caffemodel"):
        from caffe_escoin_tpu_torch.tools.caffemodel import (
            assign_to_params, batchnorm_state, load_caffemodel)

        loaded = load_caffemodel(args.weights)
        params = assign_to_params(base_net, params, loaded)
        for n, st in batchnorm_state(loaded).items():
            if n in state:
                state[n] = st
        print(f"parity on imported caffemodel weights: {args.weights}")
    elif args.weights:
        from caffe_escoin_tpu_torch.engine.checkpoint import \
            load_checkpoint_full

        loaded, _, net_state, _ = load_checkpoint_full(
            args.weights.removesuffix(".npz"))
        for n, p in loaded.items():
            if n in params:
                params[n] = p
        for n, st in (net_state or {}).items():
            if n in state:
                state[n] = st
        print(f"parity on checkpoint weights: {args.weights}")

    pruned = dict(params)
    if args.sparsity > 0:
        for layer in base_net.layers:
            n = layer.spec.name
            if n in pruned and layer.spec.type in ("Convolution",
                                                   "ConvolutionReLU"):
                w = pruned[n]["w"].numpy()
                if w.shape[0] * w.shape[1] * w.shape[2] < 32:
                    continue
                pruned[n] = dict(pruned[n], w=torch.from_numpy(
                    prune_conv_weight(w, args.sparsity,
                                      tuple(args.block_shape))))

    def maybe_fuse(net, p):
        if not args.fuse:
            return net, p, state
        from caffe_escoin_tpu_torch.nn.fuse import fuse_inference

        fnet, fp = fuse_inference(net, p, state=state)
        return fnet, fp, fnet.state0  # the BatchNorms that did not fold

    xs = [torch.from_numpy(rng.standard_normal(data_shape).astype(
        np.float32)).to(dev) for _ in range(args.batches)]
    bnet, bparams, bstate = maybe_fuse(base_net, pruned)
    ref_fwd = bnet.inference_fn(params_to(bparams, dev),
                                state=params_to(bstate, dev))
    ref_probs = [ref_fwd({"data": x})["prob"].cpu().numpy() for x in xs]

    ok = True
    for mode in (ConvMode.LOWERED_SPARSE, ConvMode.SCONV, ConvMode.SCONV_PAR):
        net = make_net(mode)
        net.init(torch.Generator().manual_seed(args.seed),
                 {"data": data_shape})
        net, pruned_m, st_m = maybe_fuse(net, pruned)
        aligned = params_to(net.weight_align(pruned_m), dev)
        fwd = net.inference_fn(aligned, state=params_to(st_m, dev))
        max_diff = 0.0
        top1_agree = top5_overlap = total = 0
        for x, ref in zip(xs, ref_probs):
            probs = fwd({"data": x})["prob"].cpu().numpy()
            max_diff = max(max_diff, float(np.abs(probs - ref).max()))
            t1 = probs.argmax(-1)
            r1 = ref.argmax(-1)
            top1_agree += int((t1 == r1).sum())
            t5 = np.argsort(-probs, -1)[:, :5]
            r5 = np.argsort(-ref, -1)[:, :5]
            for a, b in zip(t5, r5):
                top5_overlap += len(set(a) & set(b))
            total += len(t1)
        status = "OK" if max_diff <= args.tol else "FAIL"
        ok &= max_diff <= args.tol
        print(f"{mode.name:14s}: max|dprob|={max_diff:.2e} "
              f"top1 agree {top1_agree}/{total} "
              f"top5 overlap {top5_overlap}/{5*total}  [{status}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
