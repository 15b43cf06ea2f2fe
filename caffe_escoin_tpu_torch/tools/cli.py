"""Command-line interface: the `caffe` binary equivalent (port of
``caffe_escoin_tpu/tools/cli.py``).

Reference: `tools/caffe.cpp` (493 LoC): brew commands train / test / time /
device_query with gflags `-model -weights -solver -gpu -iterations
-conv_mode` (`tools/caffe.cpp:29-60`). Models come from the zoo registry or a
NetParameter `.prototxt`, weights from a `.caffemodel` or an `.npz`
checkpoint; `--conv_mode {0,1,2,3}` maps to the same four modes. The flags
and defaults are the JAX CLI's, but ``--platform``: auto (the card; no
card is an error, never a fall-back to the CPU), cpu or cuda.

Usage:
  python -m caffe_escoin_tpu_torch.tools.cli device_query
  python -m caffe_escoin_tpu_torch.tools.cli time --model lenet --iterations 10
  python -m caffe_escoin_tpu_torch.tools.cli test --model resnet50 \\
      --conv_mode 3 --weights snap.npz --sparsity 0.9 --iterations 4
  python -m caffe_escoin_tpu_torch.tools.cli train --model lenet \\
      --solver sgd --lr 0.01 --iterations 100 --snapshot-prefix /tmp/lenet
  python -m caffe_escoin_tpu_torch.tools.cli convert_imageset list.txt \
      train.mdb --root-folder imgs/ --backend lmdb --shuffle
  python -m caffe_escoin_tpu_torch.tools.cli compute_image_mean \
      train.cerec mean.npy

`convert_imageset` and `compute_image_mean` run on the host and write the
JAX CLI's bytes for the same inputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import time


def cmd_device_query(args):
    import torch

    dev = args.device
    print(f"backend: {dev.type}")
    if dev.type == "cuda":
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
        for i in range(torch.cuda.device_count()):
            prop = torch.cuda.get_device_properties(i)
            print(f"  device {i}: {prop.name} ({prop.total_memory >> 20} "
                  f"MiB, {prop.multi_processor_count} SMs, compute "
                  f"{prop.major}.{prop.minor})")
    else:
        print(f"  device cpu (torch {torch.__version__}, "
              f"{torch.get_num_threads()} threads)")
    return 0


def _build_net(args, include_loss, phase):
    from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                       ExecutionPolicy)
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net

    policy = ExecutionPolicy(
        conv_mode=ConvMode(args.conv_mode),
        block_shape=tuple(args.block_shape),
        sparse_threshold=args.sparse_threshold,
        sconv_threshold=args.sparse_threshold,
    )
    if args.model.endswith(".prototxt"):
        # reference NetParameter text config (`caffe test -model x.prototxt`)
        from caffe_escoin_tpu_torch.tools.prototxt import load_net

        specs, shapes, name = load_net(args.model, phase=phase,
                                       batch=args.batch)
        print(f"loaded prototxt net {name!r} ({len(specs)} layers)")
        return Net(specs, policy=policy, phase=phase), shapes
    if args.model not in ZOO:
        sys.exit(f"unknown model {args.model!r}; available: {sorted(ZOO)} "
                 f"or a .prototxt path")
    builder, input_shapes = ZOO[args.model]
    specs = builder(num_classes=args.num_classes, include_loss=include_loss)
    net = Net(specs, policy=policy, phase=phase)
    shapes = {"data": (args.batch,) + tuple(input_shapes["data"][1:])}
    if include_loss:
        shapes["label"] = (args.batch,)
    return net, shapes


def _load_or_init(net, shapes, args):
    """Params initialised from ``--seed`` (a ``torch.Generator``), then the
    layers ``--weights`` holds, matched by name (CopyTrainedLayersFrom); the
    BatchNorm moving statistics go to ``net.state0``. CPU tensors."""
    import torch

    params = net.init(torch.Generator().manual_seed(args.seed), shapes)
    if args.weights and args.weights.endswith(".caffemodel"):
        from caffe_escoin_tpu_torch.tools.caffemodel import (
            assign_to_params, batchnorm_state, load_caffemodel)

        loaded = load_caffemodel(args.weights)
        params = assign_to_params(net, params, loaded)
        for name, st in batchnorm_state(loaded).items():
            if name in net.state0:
                net.state0[name] = st
        print(f"imported caffemodel weights from {args.weights}")
    elif args.weights:
        from caffe_escoin_tpu_torch.engine.checkpoint import \
            load_checkpoint_full

        loaded, _, net_state, _ = load_checkpoint_full(
            args.weights.removesuffix(".npz"))
        for name, p in loaded.items():
            if name in params:
                params[name] = p
        # trained moving statistics reach net.state0 as from a caffemodel
        for name, st in (net_state or {}).items():
            if name in net.state0:
                net.state0[name] = st
        print(f"loaded weights from {args.weights}")
    return params


def _maybe_prune(net, params, args):
    """Conv weights pruned to ``--sparsity`` in ``--block-shape`` blocks; a
    conv with kh*kw*cin < 32 stays dense, as in the reference."""
    if args.sparsity <= 0:
        return params
    import torch

    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    out = dict(params)
    bs = tuple(args.block_shape)
    for layer in net.layers:
        n = layer.spec.name
        if n in out and layer.spec.type in ("Convolution", "ConvolutionReLU"):
            w = out[n]["w"].numpy()
            if w.shape[2] * w.shape[0] * w.shape[1] < 32:
                continue  # skip tiny first layers (dense in reference too)
            out[n] = dict(out[n], w=torch.from_numpy(
                prune_conv_weight(w, args.sparsity, bs)))
    print(f"pruned conv weights to {args.sparsity:.0%} block sparsity")
    return out


def _to_device(net, params, args):
    """Params and ``net.state0`` on ``args.device``."""
    from caffe_escoin_tpu_torch.nn import params_to

    net.state0 = params_to(net.state0, args.device)
    return params_to(params, args.device)


def _sync(args):
    import torch

    if args.device.type == "cuda":
        torch.cuda.synchronize(args.device)


def _prepared(args):
    """The net and its params as ``test`` and ``time`` run them: built,
    initialised or loaded, pruned, weight-aligned when ``--conv_mode`` is
    sparse and ``--sparsity`` > 0 (as the JAX CLI), on the device."""
    net, shapes = _build_net(args, include_loss=False, phase="test")
    params = _load_or_init(net, shapes, args)
    params = _maybe_prune(net, params, args)
    if args.conv_mode != 0 and args.sparsity > 0:
        params = net.weight_align(params)
        print("weight_align: sparse artifacts compiled")
    return net, shapes, _to_device(net, params, args)


def cmd_test(args):
    """Scoring run with per-iteration timing — mirrors `caffe test`
    (`tools/caffe.cpp:311-367`). On the card the forward replays a CUDA
    graph (``inference_fn(cuda_graph=True)``, the counterpart of the JAX
    jit); its first iteration runs eagerly and captures, and is left out
    of the average, as the compile iteration is."""
    import torch

    from caffe_escoin_tpu_torch.data.datasets import synthetic_source
    from caffe_escoin_tpu_torch.utils.timing import (format_report,
                                                     time_net_layerwise)

    net, shapes, params = _prepared(args)
    src = synthetic_source(shapes["data"], num_classes=args.num_classes,
                           seed=args.seed)
    fwd = net.inference_fn(params, cuda_graph=True)
    total = 0.0
    for i in range(args.iterations):
        batch = {"data": torch.from_numpy(src()["data"]).to(args.device)}
        _sync(args)
        t0 = time.perf_counter()
        fwd(batch)
        _sync(args)
        dt = (time.perf_counter() - t0) * 1e3
        if i > 0:  # skip the capture iteration
            total += dt
        print(f"iteration {i}: forward {dt:.2f} ms")
    n = max(1, args.iterations - 1)
    print(f"average forward (excl. compile): {total / n:.2f} ms")
    if args.layerwise:
        batch = {"data": torch.from_numpy(src()["data"]).to(args.device)}
        print(format_report(time_net_layerwise(net, params, batch, iters=3)))
    return 0


def cmd_time(args):
    """`caffe time`: per-layer forward AND backward timing
    (`tools/caffe.cpp:374-461` reports both columns; --no-backward for
    forward only)."""
    import torch

    from caffe_escoin_tpu_torch.data.datasets import synthetic_source
    from caffe_escoin_tpu_torch.utils.timing import (format_report,
                                                     time_net_layerwise)

    net, shapes, params = _prepared(args)
    src = synthetic_source(shapes["data"], seed=args.seed)
    batch = {"data": torch.from_numpy(src()["data"]).to(args.device)}
    print(format_report(time_net_layerwise(net, params, batch,
                                           iters=args.iterations,
                                           backward=args.backward)))
    return 0


def cmd_train(args):
    """`caffe train`: the Solver on ``--solver`` (a solver type with the
    flags' settings, or a SolverParameter .prototxt whose ``net`` is
    followed while ``--model`` is the default), fed by a PrefetchLoader
    over the synthetic source; ``--weights`` restores a checkpoint (params,
    solver and BatchNorm state, iteration) through ``Solver.restore``.
    Snapshots after the last iteration."""
    from caffe_escoin_tpu_torch.data.datasets import synthetic_source
    from caffe_escoin_tpu_torch.data.pipeline import PrefetchLoader
    from caffe_escoin_tpu_torch.engine.solver import Solver
    from caffe_escoin_tpu_torch.engine.solvers import SolverConfig

    snapshot_prefix = args.snapshot_prefix
    snapshot_interval = args.snapshot_interval
    display = args.display
    if args.solver.endswith(".prototxt"):
        # reference SolverParameter text config (`caffe train -solver x`)
        from caffe_escoin_tpu_torch.tools.prototxt import load_solver

        cfg, run = load_solver(args.solver)
        if run.get("net") and args.model == "lenet":
            # --model left at its default: follow the solver's net, as a
            # path or relative to the solver file's directory
            cand = run["net"]
            if not os.path.exists(cand):
                cand = os.path.join(os.path.dirname(args.solver),
                                    os.path.basename(run["net"]))
            if os.path.exists(cand):
                args.model = cand
        if args.iterations:
            cfg = dataclasses.replace(cfg, max_iter=args.iterations)
        snapshot_prefix = run.get("snapshot_prefix") or snapshot_prefix
        snapshot_interval = run.get("snapshot") or snapshot_interval
        display = run.get("display") or display
    else:
        cfg = SolverConfig(
            solver_type=args.solver, base_lr=args.lr, momentum=args.momentum,
            weight_decay=args.weight_decay, lr_policy=args.lr_policy,
            gamma=args.gamma, step_size=args.step_size,
            max_iter=args.iterations,
        )
    net, shapes = _build_net(args, include_loss=True, phase="train")
    solver = Solver(net, cfg, snapshot_prefix=snapshot_prefix,
                    snapshot_interval=snapshot_interval, display=display,
                    seed=args.seed, device=args.device)
    solver.init(shapes)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGHUP)}
    solver.install_signal_handlers()
    try:
        if args.weights:
            solver.restore(args.weights.removesuffix(".npz"))
        src = synthetic_source(shapes["data"], num_classes=args.num_classes,
                               seed=args.seed)
        with PrefetchLoader(src, device=args.device) as loader:
            solver.solve(loader, args.iterations)
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    print(f"done at iteration {solver.iter}")
    return 0


def cmd_export_caffemodel(args):
    """Export the current weights (a checkpoint, a re-exported
    .caffemodel, or the seed's initialisation) as a binary NetParameter,
    the reverse of `Net::CopyTrainedLayersFrom` (`src/caffe/net.cpp:910+`
    `Net::ToProto`)."""
    from caffe_escoin_tpu_torch.tools.caffemodel import save_caffemodel

    net, shapes = _build_net(args, phase="test", include_loss=False)
    params = _load_or_init(net, shapes, args)
    n = save_caffemodel(net, params, args.output, state=net.state0,
                        net_name=args.model)
    print(f"exported {n} weighted layers -> {args.output}")
    return 0


def cmd_export_prototxt(args):
    """Export a model's LayerSpecs as NetParameter prototxt text, the
    reverse of prototxt ingestion (`python/caffe/net_spec.py` to_proto).
    With --fuse, the inference-fused graph (BN/Scale folds, ReLU and
    residual epilogues)."""
    from caffe_escoin_tpu_torch.tools.prototxt import net_to_prototxt

    net, shapes = _build_net(args, phase="test", include_loss=False)
    if args.fuse:
        from caffe_escoin_tpu_torch.nn.fuse import fuse_inference

        params = _load_or_init(net, shapes, args)
        net, _ = fuse_inference(net, params, state=net.state0)
    specs = [l.spec for l in net.layers]
    text = net_to_prototxt(specs, shapes, name=args.model,
                           compat=args.compat)
    with open(args.output, "w") as fh:
        fh.write(text)
    print(f"exported {len(specs)} layers -> {args.output} "
          f"(compat={args.compat})")
    return 0


def cmd_convert_imageset(args):
    """`tools/convert_imageset.cpp`: a "<path> <label>" list file -> a record
    database, `--backend cerec` (the default) or `--backend lmdb` (Datum
    records under "%08d" keys, data/lmdb_io.py). Images are decoded with
    PIL, as color unless `--gray`, resized when both resize flags are
    set; `--shuffle` permutes the list with Python's `random` from
    `--seed`, as the JAX CLI does."""
    import numpy as np

    from caffe_escoin_tpu_torch.data.datasets import write_cerec
    from caffe_escoin_tpu_torch.nn.data_layers import load_image

    root = args.root_folder
    with open(args.listfile) as f:
        entries = [ln.split() for ln in f if ln.strip()]
    if args.shuffle:
        import random

        random.Random(args.seed).shuffle(entries)
    imgs, labels = [], []
    for path, label in entries:
        imgs.append(load_image(
            os.path.join(root, path), color=not args.gray,
            new_height=args.resize_height, new_width=args.resize_width))
        labels.append(float(label))
    if args.backend == "lmdb":
        from caffe_escoin_tpu_torch.data.lmdb_io import (datum_encode,
                                                         write_lmdb)

        items = [(b"%08d" % i, datum_encode(np.asarray(img), label=int(lb)))
                 for i, (img, lb) in enumerate(zip(imgs, labels))]
        write_lmdb(args.output, items)
    else:
        write_cerec(args.output, np.stack(imgs),
                    np.asarray(labels, np.float32))
    print(f"wrote {len(imgs)} records to {args.output}")
    return 0


def cmd_compute_image_mean(args):
    """`tools/compute_image_mean.cpp`: a .cerec file -> its per-pixel mean
    [H, W, C] as float32 .npy (summed in float64)."""
    import numpy as np

    from caffe_escoin_tpu_torch.data.datasets import (cerec_source,
                                                      read_cerec_header)

    header = read_cerec_header(args.source)
    n = header["num"]
    src = cerec_source(args.source, batch=min(64, n), loop=True)
    total = np.zeros(header["sample_shape"], np.float64)
    count = 0
    while count < n:
        d = np.asarray(src()["data"], np.float64)[:n - count]
        total += d.sum(axis=0)
        count += len(d)
    mean = (total / max(1, count)).astype(np.float32)
    np.save(args.output, mean)
    print(f"mean over {count} images -> {args.output} "
          f"(channel means: {mean.mean(axis=(0, 1))})")
    return 0


def cmd_extract_features(args):
    """`tools/extract_features.cpp`: run the net forward and dump the named
    blobs of each batch to an .npz archive."""
    import numpy as np
    import torch

    net, shapes = _build_net(args, include_loss=False, phase="test")
    params = _load_or_init(net, shapes, args)
    params = _maybe_prune(net, params, args)
    aligned = _to_device(net, net.weight_align(params), args)
    blobs = args.blobs.split(",")
    feats = {b: [] for b in blobs}
    rng = np.random.default_rng(args.seed)
    fwd = net.inference_fn(aligned, return_blobs=True)
    for _ in range(args.iterations):
        x = rng.standard_normal(shapes["data"]).astype(np.float32)
        outs = fwd({"data": torch.from_numpy(x).to(args.device)})
        for b in blobs:
            feats[b].append(outs[b].cpu().numpy())
    np.savez(args.output, **{b: np.concatenate(v) for b, v in feats.items()})
    print(f"extracted {blobs} x{args.iterations} batches -> {args.output}")
    return 0


def cmd_draw_net(args):
    """`python/draw_net.py`: model -> Graphviz DOT file."""
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.tools.draw import draw_net_to_file

    if args.model not in ZOO:
        sys.exit(f"unknown model {args.model!r}; available: {sorted(ZOO)}")
    builder, _ = ZOO[args.model]
    draw_net_to_file(builder(), args.output, name=args.model,
                     rankdir=args.rankdir)
    print(f"wrote {args.output} (render: dot -Tpng {args.output})")
    return 0


def main(argv=None):
    from caffe_escoin_tpu_torch.utils.benchmark import (PLATFORMS,
                                                        force_platform)

    ap = argparse.ArgumentParser(prog="caffe-escoin-torch")
    sub = ap.add_subparsers(dest="command", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--model", default="lenet")
    common.add_argument("--batch", type=int, default=8)
    common.add_argument("--num-classes", type=int, default=10)
    common.add_argument("--weights", default="")
    common.add_argument("--conv_mode", type=int, default=0,
                        help="0=LOWERED_GEMM 1=LOWERED_SPARSE 2=SCONV 3=SCONV_PAR")
    common.add_argument("--sparsity", type=float, default=0.0)
    common.add_argument("--block-shape", type=int, nargs=2, default=[128, 128])
    common.add_argument("--sparse-threshold", type=float, default=0.5)
    common.add_argument("--iterations", type=int, default=10)
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--platform", default="auto", choices=PLATFORMS,
                        help="auto and cuda run on the card (none here is "
                             "an error); cpu on the CPU")

    sub.add_parser("device_query", parents=[common]).set_defaults(
        fn=cmd_device_query)
    p_test = sub.add_parser("test", parents=[common])
    p_test.add_argument("--layerwise", action="store_true")
    p_test.set_defaults(fn=cmd_test)
    p_time = sub.add_parser("time", parents=[common])
    p_time.add_argument("--backward", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="also time per-layer backward (caffe time "
                             "reports both; --no-backward for forward-only)")
    p_time.set_defaults(fn=cmd_time)
    p_train = sub.add_parser("train", parents=[common])
    p_train.add_argument("--solver", default="sgd",
                         help="solver type (sgd|nesterov|adagrad|rmsprop|"
                              "adadelta|adam) or a solver .prototxt path")
    p_train.add_argument("--lr", type=float, default=0.01)
    p_train.add_argument("--momentum", type=float, default=0.9)
    p_train.add_argument("--weight-decay", type=float, default=0.0)
    p_train.add_argument("--lr-policy", default="fixed")
    p_train.add_argument("--gamma", type=float, default=0.1)
    p_train.add_argument("--step-size", type=int, default=100000)
    p_train.add_argument("--snapshot-prefix", default="snapshot")
    p_train.add_argument("--snapshot-interval", type=int, default=0)
    p_train.add_argument("--display", type=int, default=20)
    p_train.set_defaults(fn=cmd_train)

    p_expp = sub.add_parser("export_prototxt", parents=[common])
    p_expp.add_argument("--output", required=True,
                        help="NetParameter text output path")
    p_expp.add_argument("--fuse", action="store_true",
                        help="export the inference-fused graph")
    p_expp.add_argument("--compat", default="cescoin",
                        choices=["cescoin", "caffe"],
                        help="'caffe' drops framework-only params for "
                             "strict reference consumption")
    p_expp.set_defaults(fn=cmd_export_prototxt)

    p_exp = sub.add_parser("export_caffemodel", parents=[common])
    p_exp.add_argument("--output", required=True,
                       help="destination .caffemodel path")
    p_exp.set_defaults(fn=cmd_export_caffemodel)

    p_conv = sub.add_parser("convert_imageset")
    p_conv.add_argument("listfile")
    p_conv.add_argument("output")
    p_conv.add_argument("--root-folder", default="")
    p_conv.add_argument("--resize-height", type=int, default=0)
    p_conv.add_argument("--resize-width", type=int, default=0)
    p_conv.add_argument("--gray", action="store_true")
    p_conv.add_argument("--shuffle", action="store_true")
    p_conv.add_argument("--seed", type=int, default=0)
    p_conv.add_argument("--backend", choices=["cerec", "lmdb"],
                        default="cerec")
    p_conv.set_defaults(fn=cmd_convert_imageset)

    p_mean = sub.add_parser("compute_image_mean")
    p_mean.add_argument("source")
    p_mean.add_argument("output")
    p_mean.set_defaults(fn=cmd_compute_image_mean)

    p_ext = sub.add_parser("extract_features", parents=[common])
    p_ext.add_argument("--blobs", required=True,
                       help="comma-separated blob names to dump")
    p_ext.add_argument("--output", default="features.npz")
    p_ext.set_defaults(fn=cmd_extract_features)

    p_draw = sub.add_parser("draw_net")
    p_draw.add_argument("--model", default="lenet")
    p_draw.add_argument("--output", default="net.dot")
    p_draw.add_argument("--rankdir", default="LR")
    p_draw.set_defaults(fn=cmd_draw_net)

    args = ap.parse_args(argv)
    if hasattr(args, "platform"):
        try:
            args.device = force_platform(args.platform)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
