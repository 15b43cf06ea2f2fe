"""VGG-16 (port of ``caffe_escoin_tpu/models/vgg.py``; the same specs).

Thirteen 3x3 stride-1 convs with ReLU in their epilogue, five 2x2 max
pools, fc6/fc7 with ReLU and Dropout, fc8 and Softmax.
"""

from __future__ import annotations

from caffe_escoin_tpu_torch.nn.net import LayerSpec

_CFG = [  # (stage, [channels per conv])
    (1, [64, 64]),
    (2, [128, 128]),
    (3, [256, 256, 256]),
    (4, [512, 512, 512]),
    (5, [512, 512, 512]),
]


def vgg16(num_classes: int = 1000, include_loss: bool = False,
          fuse_relu: bool = True):
    """Inputs: data [N, 224, 224, 3] (+ label [N] with include_loss). Ends
    in Softmax ("prob"), or with include_loss in SoftmaxWithLoss and the
    test phase's top-1 and top-5 Accuracy."""
    conv_type = "ConvolutionReLU" if fuse_relu else "Convolution"
    specs = []
    bottom = "data"
    for stage, chans in _CFG:
        for i, c in enumerate(chans, 1):
            name = f"conv{stage}_{i}"
            specs.append(LayerSpec(name, conv_type, (bottom,),
                                   params=dict(num_output=c, kernel=3, pad=1,
                                               weight_filler={"type": "xavier"})))
            bottom = name
        pool = f"pool{stage}"
        specs.append(LayerSpec(pool, "Pooling", (bottom,),
                               params=dict(kernel=2, stride=2)))
        bottom = pool
    specs += [
        LayerSpec("fc6", "InnerProduct", (bottom,),
                  params=dict(num_output=4096, weight_filler={"type": "xavier"})),
        LayerSpec("relu6", "ReLU", ("fc6",), tops=("fc6r",)),
        LayerSpec("drop6", "Dropout", ("fc6r",), tops=("fc6d",),
                  params=dict(ratio=0.5)),
        LayerSpec("fc7", "InnerProduct", ("fc6d",),
                  params=dict(num_output=4096, weight_filler={"type": "xavier"})),
        LayerSpec("relu7", "ReLU", ("fc7",), tops=("fc7r",)),
        LayerSpec("drop7", "Dropout", ("fc7r",), tops=("fc7d",),
                  params=dict(ratio=0.5)),
        LayerSpec("fc8", "InnerProduct", ("fc7d",),
                  params=dict(num_output=num_classes,
                              weight_filler={"type": "xavier"})),
    ]
    if include_loss:
        specs += [
            LayerSpec("loss", "SoftmaxWithLoss", ("fc8", "label")),
            LayerSpec("accuracy", "Accuracy", ("fc8", "label"), phase="test"),
            LayerSpec("accuracy_top5", "Accuracy", ("fc8", "label"),
                      phase="test", params=dict(top_k=5)),
        ]
    else:
        specs += [LayerSpec("prob", "Softmax", ("fc8",))]
    return specs


INPUT_SHAPES = {"data": (16, 224, 224, 3)}
