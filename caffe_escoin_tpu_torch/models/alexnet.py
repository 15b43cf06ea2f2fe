"""AlexNet / CaffeNet (reference `models/bvlc_alexnet/train_val.prototxt`,
`models/bvlc_reference_caffenet/`).

Port of ``caffe_escoin_tpu/models/alexnet.py``: the same specs.

BASELINE config 3: per-layer CSR weights at 70-95% sparsity sweep. The
grouped conv2/conv4/conv5 (group=2) exercise the block-diagonal GEMM-view
expansion; the LRN layers exercise cross-channel normalization.
"""

from __future__ import annotations

from caffe_escoin_tpu_torch.nn.net import LayerSpec


def alexnet(num_classes: int = 1000, include_loss: bool = False,
            fuse_relu: bool = True):
    """Inputs: data [N, 227, 227, 3] (+ label [N])."""
    conv_type = "ConvolutionReLU" if fuse_relu else "Convolution"

    def conv(name, bottom, cout, k, s=1, p=0, group=1):
        return LayerSpec(name, conv_type, (bottom,),
                         params=dict(num_output=cout, kernel=k, stride=s,
                                     pad=p, group=group,
                                     weight_filler={"type": "gaussian",
                                                    "std": 0.01}))

    specs = [
        conv("conv1", "data", 96, 11, s=4),
        LayerSpec("norm1", "LRN", ("conv1",),
                  params=dict(local_size=5, alpha=1e-4, beta=0.75)),
        LayerSpec("pool1", "Pooling", ("norm1",),
                  params=dict(kernel=3, stride=2)),
        conv("conv2", "pool1", 256, 5, p=2, group=2),
        LayerSpec("norm2", "LRN", ("conv2",),
                  params=dict(local_size=5, alpha=1e-4, beta=0.75)),
        LayerSpec("pool2", "Pooling", ("norm2",),
                  params=dict(kernel=3, stride=2)),
        conv("conv3", "pool2", 384, 3, p=1),
        conv("conv4", "conv3", 384, 3, p=1, group=2),
        conv("conv5", "conv4", 256, 3, p=1, group=2),
        LayerSpec("pool5", "Pooling", ("conv5",),
                  params=dict(kernel=3, stride=2)),
        LayerSpec("fc6", "InnerProduct", ("pool5",),
                  params=dict(num_output=4096,
                              weight_filler={"type": "gaussian", "std": 0.005})),
        LayerSpec("relu6", "ReLU", ("fc6",), tops=("fc6r",)),
        LayerSpec("drop6", "Dropout", ("fc6r",), tops=("fc6d",),
                  params=dict(ratio=0.5)),
        LayerSpec("fc7", "InnerProduct", ("fc6d",),
                  params=dict(num_output=4096,
                              weight_filler={"type": "gaussian", "std": 0.005})),
        LayerSpec("relu7", "ReLU", ("fc7",), tops=("fc7r",)),
        LayerSpec("drop7", "Dropout", ("fc7r",), tops=("fc7d",),
                  params=dict(ratio=0.5)),
        LayerSpec("fc8", "InnerProduct", ("fc7d",),
                  params=dict(num_output=num_classes,
                              weight_filler={"type": "gaussian", "std": 0.01})),
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


INPUT_SHAPES = {"data": (32, 227, 227, 3)}
