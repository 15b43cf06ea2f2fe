"""Net surgery: casting a classifier into a fully-convolutional net (port of
``examples/net_surgery.py``): the reference's flagship pycaffe demo
(`examples/net_surgery.ipynb` /
`examples/net_surgery/bvlc_caffenet_full_conv.prototxt`). fc6/fc7/fc8
become 6x6 / 1x1 / 1x1 convolutions carrying the SAME weights, so the net
slides over larger images and emits a dense score MAP instead of a single
vector.

Surgery here is plain dict editing: params are dicts of tensors, so the
reference's `net.params['fc6'][0].data[...] = ...` becomes a reshape into
the conv weight layout (HWIO). The invariant checked at the end: on a
classification-sized input, the full-conv net's 1x1 score map equals the
original classifier's probabilities (max abs err < 1e-5; f32 with TF32 off
on the card).

Usage (``--platform`` auto, the default, is the card; an error without
one):
    python -m caffe_escoin_tpu_torch.examples.net_surgery --platform cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from caffe_escoin_tpu_torch.examples.digits import log
from caffe_escoin_tpu_torch.models.caffenet import _trunk, caffenet
from caffe_escoin_tpu_torch.nn import LayerSpec, Net, params_to
from caffe_escoin_tpu_torch.utils.benchmark import PLATFORMS, force_platform

PARITY_TOL = 1e-5
FC_TO_CONV = [("fc6", "fc6-conv", 6, 256), ("fc7", "fc7-conv", 1, 4096),
              ("fc8", "fc8-conv", 1, 4096)]


def fullconv_specs(num_classes=1000):
    """CaffeNet trunk with fc6/fc7/fc8 as convolutions (the reference's
    bvlc_caffenet_full_conv.prototxt)."""
    specs = [s for s in _trunk(fuse_relu=False)
             if not s.name.startswith(("fc", "relu6", "relu7",
                                       "drop6", "drop7"))]
    specs += [
        LayerSpec("fc6-conv", "Convolution", ("pool5",),
                  params=dict(num_output=4096, kernel=6)),
        LayerSpec("relu6", "ReLU", ("fc6-conv",), tops=("fc6r",)),
        LayerSpec("fc7-conv", "Convolution", ("fc6r",),
                  params=dict(num_output=4096, kernel=1)),
        LayerSpec("relu7", "ReLU", ("fc7-conv",), tops=("fc7r",)),
        LayerSpec("fc8-conv", "Convolution", ("fc7r",),
                  params=dict(num_output=num_classes, kernel=1)),
        LayerSpec("prob", "Softmax", ("fc8-conv",)),
    ]
    return specs


def transplant_fc_to_conv(fc_w, fc_b, kernel, cin):
    """Caffe stores fc rows over the flattened (h, w, c) bottom (the NHWC
    flatten order of this package); a conv expects HWIO. The fc weight is
    [k*k*cin, cout] -> reshape to [k, k, cin, cout]: the coefficients are
    IDENTICAL, only the view changes (net_surgery.ipynb 'the weights are
    the same, up to reshape')."""
    cout = fc_w.shape[1]
    return fc_w.reshape(kernel, kernel, cin, cout), fc_b


def surgery(params, fparams, log=log):
    """The full-conv net's params: ``fparams`` with fc6-8 of the
    classifier's ``params`` transplanted into fc6-conv..fc8-conv and
    conv1-5 taken over."""
    fparams = dict(fparams)
    for src, dst, k, cin in FC_TO_CONV:
        w, b = params[src]["w"], params[src]["b"]
        cw, cb = transplant_fc_to_conv(w, b, k, cin)
        if tuple(fparams[dst]["w"].shape) != tuple(cw.shape):
            raise ValueError(f"{src} -> {dst}: {tuple(cw.shape)} against "
                             f"{tuple(fparams[dst]['w'].shape)}")
        fparams[dst] = dict(fparams[dst], w=cw, b=cb)
        log(f"transplanted {src} {tuple(w.shape)} -> {dst} "
            f"{tuple(cw.shape)}")
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5"):
        fparams[name] = params[name]
    return fparams


def run(platform="auto", num_classes=100, log=log):
    """Surgery on a randomly initialised CaffeNet (``num_classes`` outputs:
    100 keeps the demo light, the same math as 1000) on the device
    ``platform`` names; raises unless the 227x227 score map equals the
    classifier's probabilities within ``PARITY_TOL`` and a 451x451 input
    gives a map larger than 1x1. Returns (max abs err, map shape NHWC)."""
    dev = force_platform(platform)
    rng = np.random.default_rng(0)
    shape = {"data": (1, 227, 227, 3)}

    # the trained classifier (random weights stand in for the zoo download)
    cls_net = Net(caffenet(num_classes=num_classes), phase="test")
    params = params_to(cls_net.init(torch.Generator().manual_seed(0), shape),
                       dev)
    fc_net = Net(fullconv_specs(num_classes=num_classes), phase="test")
    fparams = surgery(params, params_to(
        fc_net.init(torch.Generator().manual_seed(1), shape), dev), log)

    # invariant: on the classifier-sized input the 1x1 score map equals
    # the original probabilities
    x = torch.as_tensor(rng.standard_normal((1, 227, 227, 3)).astype(
        np.float32) * 0.1).to(dev)
    logits = cls_net.inference_fn(params)({"data": x})["prob"]
    fmap = fc_net.inference_fn(fparams)({"data": x})["prob"]
    if tuple(fmap.shape[1:3]) != (1, 1):
        raise RuntimeError(f"227x227 score map {tuple(fmap.shape)}")
    err = float((fmap[:, 0, 0, :] - logits).abs().max())
    log(f"227x227 parity: score-map (1x1) vs classifier, max err {err:.2e}")
    if not err < PARITY_TOL:
        raise RuntimeError(f"227x227 parity {err:.2e} >= {PARITY_TOL}")

    # the payoff: a larger image yields a dense score map in ONE pass
    fmap = fc_net.inference_fn(fparams)({"data": torch.as_tensor(
        rng.standard_normal((1, 451, 451, 3)).astype(np.float32) * 0.1
    ).to(dev)})["prob"]
    log(f"451x451 input -> score map {tuple(fmap.shape)} "
        f"({fmap.shape[1]}x{fmap.shape[2]} positions x "
        f"{fmap.shape[3]} classes)")
    if not (fmap.shape[1] > 1 and fmap.shape[2] > 1):
        raise RuntimeError(f"451x451 score map {tuple(fmap.shape)}")
    return err, tuple(fmap.shape)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="auto", choices=PLATFORMS,
                    help="auto (the default) and cuda run on the card, an "
                         "error without one; cpu on the CPU")
    args = ap.parse_args(argv)
    try:
        force_platform(args.platform)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    err, shape = run(args.platform)
    print(f"net_surgery: parity_err {err:.2e} "
          f"map {shape[1]}x{shape[2]}x{shape[3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
