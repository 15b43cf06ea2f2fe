"""Siamese embedding training with SHARED parameters + ContrastiveLoss
(port of ``examples/siamese_digits.py``): the reference's
`examples/siamese/mnist_siamese_train_test.prototxt`, which ties the two
branches with `param { name: "conv1_w" }` (Caffe param ownership,
`net.cpp` param sharing). Here the tie is ``LayerSpec.share_params``
(nn/net.py): the second branch's layers run on the first branch's
parameter dicts, so there is ONE copy of the weights and the gradients of
both branches sum into it under ``torch.autograd.grad``.

Dataset: the offline digits set (``examples/digits.py``). Pairs are
sampled on the fly; sim=1 for same-class pairs, 0 otherwise (the
reference's `createLeveldbFromImagePairs` role).

Usage (``--platform`` auto, the default, is the card; an error without
one):
    python -m caffe_escoin_tpu_torch.examples.siamese_digits --iters 400 \\
        --platform cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from caffe_escoin_tpu_torch.engine.solver import Solver
from caffe_escoin_tpu_torch.engine.solvers import SolverConfig
from caffe_escoin_tpu_torch.examples.digits import load_digits_upscaled, log
from caffe_escoin_tpu_torch.nn import LayerSpec, Net
from caffe_escoin_tpu_torch.utils.benchmark import PLATFORMS, force_platform


def siamese_net(feat_dim=2):
    """Two tied LeNet-ish branches -> feat/feat_p -> ContrastiveLoss.
    Mirrors mnist_siamese_train_test.prototxt's structure; branch-2 layers
    carry share_params pointing at branch 1."""

    def branch(s, share):
        specs = []
        for name, typ, bottoms, params in [
            ("conv1", "Convolution", (f"data{s}",),
             dict(num_output=20, kernel=5,
                  weight_filler={"type": "xavier"})),
            ("pool1", "Pooling", (f"conv1{s}",),
             dict(kernel=2, stride=2)),
            ("conv2", "Convolution", (f"pool1{s}",),
             dict(num_output=50, kernel=5,
                  weight_filler={"type": "xavier"})),
            ("pool2", "Pooling", (f"conv2{s}",), dict(kernel=2, stride=2)),
            ("ip1", "InnerProduct", (f"pool2{s}",),
             dict(num_output=500, weight_filler={"type": "xavier"})),
            ("relu1", "ReLU", (f"ip1{s}",), {}),
            ("feat", "InnerProduct", (f"relu1{s}",),
             dict(num_output=feat_dim, weight_filler={"type": "xavier"})),
        ]:
            specs.append(LayerSpec(
                f"{name}{s}", typ, bottoms, tops=(f"{name}{s}",),
                params=dict(params),
                share_params=(name if share and typ in (
                    "Convolution", "InnerProduct") else None)))
        return specs

    specs = branch("", share=False) + branch("_p", share=True)
    specs.append(LayerSpec("loss", "ContrastiveLoss",
                           ("feat", "feat_p", "sim"),
                           params=dict(margin=1.0)))
    return specs


def pair_iter(data, labels, batch, seed=0):
    rng = np.random.default_rng(seed)
    n = len(data)
    while True:
        i = rng.integers(0, n, batch)
        j = rng.integers(0, n, batch)
        # bias half the batch toward positive pairs (random pairing is ~90%
        # negative on 10 classes; the reference's pair db was 50/50)
        for b in range(0, batch, 2):
            same = np.flatnonzero(labels == labels[i[b]])
            j[b] = same[rng.integers(0, len(same))]
        yield {"data": data[i], "data_p": data[j],
               "sim": (labels[i] == labels[j]).astype(np.float32)}


def run(args, log=log):
    """Train the tied pair on the device ``args.platform`` names, then embed
    the test digits through branch 1 alone (the deployment shape of a
    siamese model: one tower) and score: same-class pairs must sit closer
    than different-class pairs (raises otherwise). Returns the mean
    positive and negative distances, the pair accuracy at threshold 0.5
    and the Solver."""
    dev = force_platform(args.platform)
    (trd, trl), (ted, tel) = load_digits_upscaled(28, 1)
    cfg = SolverConfig(solver_type="sgd", base_lr=args.base_lr, momentum=0.9,
                       lr_policy="inv", gamma=1e-4, power=0.75,
                       weight_decay=0.0)
    net = Net(siamese_net(), phase="train")
    solver = Solver(net, cfg, device=dev)
    solver.init({"data": (args.batch, 28, 28, 1),
                 "data_p": (args.batch, 28, 28, 1),
                 "sim": (args.batch,)})
    # ONE parameter copy: branch-2 layers share branch 1's dicts
    if "conv1_p" in solver.params or "conv1" not in solver.params:
        raise RuntimeError(f"siamese: params {sorted(solver.params)} are "
                           f"not one shared copy")
    solver.step(pair_iter(trd, trl, args.batch), args.iters, log=log)

    feat_specs = [s for s in siamese_net()
                  if not s.name.endswith("_p") and s.name != "loss"]
    test_net = Net(feat_specs, phase="test", device=dev)
    out = test_net.inference_fn(solver.params)(
        {"data": torch.as_tensor(ted).to(dev)})
    feat = out["feat"].cpu().numpy()
    rng = np.random.default_rng(1)
    i = rng.integers(0, len(feat), 2000)
    j = rng.integers(0, len(feat), 2000)
    d = np.linalg.norm(feat[i] - feat[j], axis=1)
    sim = tel[i] == tel[j]
    pos, neg = d[sim], d[~sim]
    thresh = 0.5
    acc = ((d < thresh) == sim).mean()
    log(f"pairs: pos mean dist {pos.mean():.3f}, neg mean dist "
        f"{neg.mean():.3f}, pair accuracy @ {thresh}: {acc:.3f}")
    if not neg.mean() > pos.mean():
        raise RuntimeError("embedding did not separate classes")
    return dict(pos=float(pos.mean()), neg=float(neg.mean()),
                pair_acc=float(acc), solver=solver)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--base_lr", type=float, default=0.02)
    ap.add_argument("--platform", default="auto", choices=PLATFORMS,
                    help="auto (the default) and cuda run on the card, an "
                         "error without one; cpu on the CPU")
    args = ap.parse_args(argv)
    try:
        force_platform(args.platform)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    r = run(args)
    print(f"siamese: pos {r['pos']:.3f} neg {r['neg']:.3f} "
          f"pair_acc {r['pair_acc']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
