"""GoogLeNet v1 / Inception-v1 (reference `models/bvlc_googlenet/
train_val.prototxt`, sparse variant `test_sconv.prototxt`).

Port of ``caffe_escoin_tpu/models/googlenet.py``: the same specs.

BASELINE config 4: many small 1x1/3x3/5x5 convs — the BSR/BSC blocked-kernel
workload. Tower structure exercises Concat and per-branch sparse dispatch.
"""

from __future__ import annotations

from caffe_escoin_tpu_torch.nn.net import LayerSpec

# (name, out_1x1, reduce_3x3, out_3x3, reduce_5x5, out_5x5, pool_proj)
_INCEPTION = [
    ("3a", 64, 96, 128, 16, 32, 32),
    ("3b", 128, 128, 192, 32, 96, 64),
    ("4a", 192, 96, 208, 16, 48, 64),
    ("4b", 160, 112, 224, 24, 64, 64),
    ("4c", 128, 128, 256, 24, 64, 64),
    ("4d", 112, 144, 288, 32, 64, 64),
    ("4e", 256, 160, 320, 32, 128, 128),
    ("5a", 256, 160, 320, 32, 128, 128),
    ("5b", 384, 192, 384, 48, 128, 128),
]


def _conv(name, bottom, cout, k, s=1, p=0, fuse_relu=True, phase=None):
    t = "ConvolutionReLU" if fuse_relu else "Convolution"
    return LayerSpec(name, t, (bottom,), phase=phase,
                     params=dict(num_output=cout, kernel=k, stride=s, pad=p,
                                 weight_filler={"type": "xavier"}))


def _inception(name, bottom, cfg, fuse_relu=True):
    _, c1, r3, c3, r5, c5, pp = cfg
    p = f"inception_{name}"
    return [
        _conv(f"{p}/1x1", bottom, c1, 1, fuse_relu=fuse_relu),
        _conv(f"{p}/3x3_reduce", bottom, r3, 1, fuse_relu=fuse_relu),
        _conv(f"{p}/3x3", f"{p}/3x3_reduce", c3, 3, p=1, fuse_relu=fuse_relu),
        _conv(f"{p}/5x5_reduce", bottom, r5, 1, fuse_relu=fuse_relu),
        _conv(f"{p}/5x5", f"{p}/5x5_reduce", c5, 5, p=2, fuse_relu=fuse_relu),
        LayerSpec(f"{p}/pool", "Pooling", (bottom,),
                  params=dict(kernel=3, stride=1, pad=1)),
        _conv(f"{p}/pool_proj", f"{p}/pool", pp, 1, fuse_relu=fuse_relu),
        LayerSpec(f"{p}/output", "Concat",
                  (f"{p}/1x1", f"{p}/3x3", f"{p}/5x5", f"{p}/pool_proj")),
    ]


def _aux_head(idx, bottom, num_classes):
    """Train-phase auxiliary classifier (loss1/loss2 at inception 4a/4d,
    `models/bvlc_googlenet/train_val.prototxt:928,1691`): 5x5/s3 avg pool ->
    1x1x128 conv -> fc1024 -> dropout 0.7 -> classifier, loss_weight 0.3."""
    p = f"loss{idx}"
    return [
        LayerSpec(f"{p}/ave_pool", "Pooling", (bottom,), phase="train",
                  params=dict(kernel=5, stride=3, mode="avg")),
        _conv(f"{p}/conv", f"{p}/ave_pool", 128, 1, phase="train"),
        LayerSpec(f"{p}/fc", "InnerProduct", (f"{p}/conv",), phase="train",
                  params=dict(num_output=1024,
                              weight_filler={"type": "xavier"})),
        LayerSpec(f"{p}/relu_fc", "ReLU", (f"{p}/fc",), tops=(f"{p}/fcr",),
                  phase="train"),
        LayerSpec(f"{p}/drop_fc", "Dropout", (f"{p}/fcr",),
                  tops=(f"{p}/fcd",), phase="train", params=dict(ratio=0.7)),
        LayerSpec(f"{p}/classifier", "InnerProduct", (f"{p}/fcd",),
                  phase="train",
                  params=dict(num_output=num_classes,
                              weight_filler={"type": "xavier"})),
        LayerSpec(f"{p}/loss", "SoftmaxWithLoss",
                  (f"{p}/classifier", "label"), phase="train",
                  loss_weight=0.3),
    ]


def googlenet(num_classes: int = 1000, include_loss: bool = False,
              fuse_relu: bool = True):
    """Inputs: data [N, 224, 224, 3] (+ label [N]). With include_loss the
    train phase also carries the two auxiliary heads (loss1 at 4a, loss2 at
    4d) of the reference train_val.prototxt."""
    specs = [
        _conv("conv1/7x7_s2", "data", 64, 7, s=2, p=3, fuse_relu=fuse_relu),
        LayerSpec("pool1/3x3_s2", "Pooling", ("conv1/7x7_s2",),
                  params=dict(kernel=3, stride=2)),
        LayerSpec("pool1/norm1", "LRN", ("pool1/3x3_s2",),
                  params=dict(local_size=5, alpha=1e-4, beta=0.75)),
        _conv("conv2/3x3_reduce", "pool1/norm1", 64, 1, fuse_relu=fuse_relu),
        _conv("conv2/3x3", "conv2/3x3_reduce", 192, 3, p=1, fuse_relu=fuse_relu),
        LayerSpec("conv2/norm2", "LRN", ("conv2/3x3",),
                  params=dict(local_size=5, alpha=1e-4, beta=0.75)),
        LayerSpec("pool2/3x3_s2", "Pooling", ("conv2/norm2",),
                  params=dict(kernel=3, stride=2)),
    ]
    bottom = "pool2/3x3_s2"
    for cfg in _INCEPTION:
        name = cfg[0]
        specs += _inception(name, bottom, cfg, fuse_relu)
        bottom = f"inception_{name}/output"
        if include_loss and name == "4a":
            specs += _aux_head(1, bottom, num_classes)
        elif include_loss and name == "4d":
            specs += _aux_head(2, bottom, num_classes)
        if name == "3b":
            specs.append(LayerSpec("pool3/3x3_s2", "Pooling", (bottom,),
                                   params=dict(kernel=3, stride=2)))
            bottom = "pool3/3x3_s2"
        elif name == "4e":
            specs.append(LayerSpec("pool4/3x3_s2", "Pooling", (bottom,),
                                   params=dict(kernel=3, stride=2)))
            bottom = "pool4/3x3_s2"
    specs += [
        LayerSpec("pool5/7x7_s1", "Pooling", (bottom,),
                  params=dict(mode="avg", global_pooling=True)),
        LayerSpec("pool5/drop_7x7_s1", "Dropout", ("pool5/7x7_s1",),
                  tops=("pool5d",), params=dict(ratio=0.4)),
        LayerSpec("loss3/classifier", "InnerProduct", ("pool5d",),
                  params=dict(num_output=num_classes,
                              weight_filler={"type": "xavier"})),
    ]
    if include_loss:
        specs += [
            LayerSpec("loss", "SoftmaxWithLoss", ("loss3/classifier", "label")),
            LayerSpec("accuracy", "Accuracy", ("loss3/classifier", "label"),
                      phase="test"),
            LayerSpec("accuracy_top5", "Accuracy", ("loss3/classifier", "label"),
                      phase="test", params=dict(top_k=5)),
        ]
    else:
        specs += [LayerSpec("prob", "Softmax", ("loss3/classifier",))]
    return specs


INPUT_SHAPES = {"data": (32, 224, 224, 3)}
