"""ResNet-50 (port of ``caffe_escoin_tpu/models/resnet.py``; the same specs).

Caffe-style: BatchNorm + Scale after every conv, bottleneck blocks with
projection shortcuts at stage starts, the stride on the 1x1 branch2a.
"""

from __future__ import annotations

from caffe_escoin_tpu_torch.nn.net import LayerSpec

_STAGES = [  # (stage_name, blocks, mid_channels, out_channels, first_stride)
    ("2", 3, 64, 256, 1),
    ("3", 4, 128, 512, 2),
    ("4", 6, 256, 1024, 2),
    ("5", 3, 512, 2048, 2),
]


def _conv_bn(name, bottom, cout, k, s=1, p=0, relu=True):
    """conv + BN + scale (+ ReLU). Returns (specs, top)."""
    specs = [
        LayerSpec(name, "Convolution", (bottom,),
                  params=dict(num_output=cout, kernel=k, stride=s, pad=p,
                              bias_term=False,
                              weight_filler={"type": "msra"})),
        LayerSpec(f"bn_{name}", "BatchNorm", (name,), tops=(f"{name}_bn",),
                  params=dict(use_global_stats=True)),
        LayerSpec(f"scale_{name}", "Scale", (f"{name}_bn",),
                  tops=(f"{name}_sc",)),
    ]
    top = f"{name}_sc"
    if relu:
        specs.append(LayerSpec(f"{name}_relu", "ReLU", (top,),
                               tops=(f"{name}_r",)))
        top = f"{name}_r"
    return specs, top


def _bottleneck(stage, idx, bottom, mid, cout, stride):
    name = f"res{stage}{chr(ord('a') + idx)}"
    specs = []
    if idx == 0:
        br1, shortcut = _conv_bn(f"{name}_branch1", bottom, cout, 1, s=stride,
                                 relu=False)
        specs += br1
    else:
        shortcut = bottom
    s2a, t = _conv_bn(f"{name}_branch2a", bottom, mid, 1, s=stride)
    specs += s2a
    s2b, t = _conv_bn(f"{name}_branch2b", t, mid, 3, p=1)
    specs += s2b
    s2c, t = _conv_bn(f"{name}_branch2c", t, cout, 1, relu=False)
    specs += s2c
    specs += [
        LayerSpec(name, "Eltwise", (shortcut, t)),
        LayerSpec(f"{name}_relu", "ReLU", (name,), tops=(f"{name}_out",)),
    ]
    return specs, f"{name}_out"


def resnet50(num_classes: int = 1000, include_loss: bool = False,
             fuse_relu: bool = True):
    """Inputs: data [N, 224, 224, 3] (+ label [N] with include_loss). Ends
    in Softmax ("prob"), or with include_loss in SoftmaxWithLoss and the
    test phase's top-1 and top-5 Accuracy. ``fuse_relu`` is accepted for
    the JAX signature and, as there, changes nothing: the graph pass
    (nn/fuse.py) fuses the ReLUs."""
    specs, top = _conv_bn("conv1", "data", 64, 7, s=2, p=3)
    specs.append(LayerSpec("pool1", "Pooling", (top,),
                           params=dict(kernel=3, stride=2)))
    top = "pool1"
    for stage, blocks, mid, cout, stride in _STAGES:
        for i in range(blocks):
            blk, top = _bottleneck(stage, i, top, mid, cout,
                                   stride if i == 0 else 1)
            specs += blk
    specs += [
        LayerSpec("pool5", "Pooling", (top,),
                  params=dict(mode="avg", global_pooling=True)),
        LayerSpec("fc1000", "InnerProduct", ("pool5",),
                  params=dict(num_output=num_classes,
                              weight_filler={"type": "xavier"})),
    ]
    if include_loss:
        specs += [
            LayerSpec("loss", "SoftmaxWithLoss", ("fc1000", "label")),
            LayerSpec("accuracy", "Accuracy", ("fc1000", "label"),
                      phase="test"),
            LayerSpec("accuracy_top5", "Accuracy", ("fc1000", "label"),
                      phase="test", params=dict(top_k=5)),
        ]
    else:
        specs += [LayerSpec("prob", "Softmax", ("fc1000",))]
    return specs


INPUT_SHAPES = {"data": (32, 224, 224, 3)}
