"""``Net.launches`` against one eager forward on the CPU: ResNet-50,
GoogLeNet and VGG-16 at batch 1 (224x224, every published width) and
AlexNet (227x227, conv2, conv4 and conv5 in two groups), their
convs with 32 or more input channels and their fcs pruned to 90% in
128x128 blocks, fused, SCONV_PAR in bf16 on the kernel routes; and VGG-16
on the XBSP branch with autotune, its measurement replaced by fixed times
(the fused kernel wins where it competes, the SpMM kernel an fc, else the
dense arm). On the CPU each kernel entry counts a launch it would make on
the card as ``calls`` and runs its plain version, so the counts a forward
adds must be what ``Net.launches`` declares."""

import numpy as np
import pytest
import torch

from caffe_escoin_tpu_torch.engine import autotune
from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import (bsc_spmm, conv_epilogue, lrn,
                                            maxpool, sconv_fused, sconv_gc,
                                            stem_conv)
from caffe_escoin_tpu_torch.models import ZOO
from caffe_escoin_tpu_torch.nn import Net, fuse_inference
from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,
                                                  prune_conv_weight)

KERNELS = {"sconv_fused": sconv_fused, "sconv_gc": sconv_gc,
           "bsc_spmm": bsc_spmm, "lrn": lrn, "maxpool": maxpool,
           "conv_epilogue": conv_epilogue, "stem_conv": stem_conv}
BLOCK = (128, 128)
# the fixed times of the autotuned case's arms (lower wins; others 2)
RANK = {"fused": 0, "bsc_spmm": 0, "dense": 1}


def _pruned(net, params):
    out = dict(params)
    for layer in net.layers:
        name, kind = layer.spec.name, layer.spec.type
        if name not in out or kind not in ("Convolution", "ConvolutionReLU",
                                           "InnerProduct"):
            continue
        w = out[name]["w"].numpy()
        if kind == "InnerProduct":
            w = prune_blocks(w, 0.9, BLOCK)
        elif w.shape[2] >= 32:
            w = prune_conv_weight(w, 0.9, BLOCK)
        out[name] = {**out[name], "w": torch.from_numpy(w)}
    return out


@pytest.mark.parametrize("model, autotuned", [
    ("resnet50", False), ("googlenet", False), ("vgg16", False),
    ("vgg16", True), ("alexnet", False)],
    ids=["resnet50", "googlenet", "vgg16", "vgg16-autotuned", "alexnet"])
def test_launches_are_what_one_forward_calls(model, autotuned, tmp_path,
                                             monkeypatch):
    if autotuned:
        monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE",
                           str(tmp_path / "arms.json"))
        monkeypatch.setattr(autotune, "measure", lambda arms, *a, **k: {
            arm: RANK.get(arm, 2) for arm in arms})
        autotune.clear()
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                          compute_dtype=torch.bfloat16, cast_back=False,
                          use_xla_sparse=autotuned, autotune=autotuned)
    build, shapes = ZOO[model]
    shapes = {"data": (1,) + tuple(shapes["data"][1:])}
    try:
        net = Net(build(), policy=pol)
        params = net.init(torch.Generator().manual_seed(0), shapes)
        fnet, fparams = fuse_inference(net, _pruned(net, params),
                                       state=net.state0)
        aligned = fnet.weight_align(fparams)
        want = fnet.launches(aligned, shapes)
        for m in KERNELS.values():
            m.reset_counts()
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            shapes["data"]).astype(np.float32))
        with torch.inference_mode():
            fnet.forward(aligned, {"data": x})
        assert {k: m.calls for k, m in KERNELS.items()} == {
            k: want[k] for k in KERNELS}
        assert set(want) <= set(KERNELS)
        assert want["sconv_fused"] > 0 and want["bsc_spmm"] > 0
        assert want["maxpool"] > 0
        assert want["lrn"] == (2 if model in ("googlenet", "alexnet") else 0)
        # the stem on its own kernel; convs too dense to prune and the
        # dense arm's picks on the epilogue
        assert want["stem_conv"] == 1
        assert want["conv_epilogue"] == {"resnet50": 1, "googlenet": 9,
                                         "vgg16": 5 if autotuned else 0,
                                         "alexnet": 0}[model]
        if model == "alexnet":
            assert (want["sconv_fused"], want["bsc_spmm"], want["maxpool"]
                    ) == (4, 3, 3)
    finally:
        autotune.clear()
