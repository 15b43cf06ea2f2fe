"""LeNet-5 (port of ``caffe_escoin_tpu/models/lenet.py``; the same specs):
the reference's `examples/mnist/lenet.prototxt`, the command line's default
model.
"""

from __future__ import annotations

from caffe_escoin_tpu_torch.nn.net import LayerSpec


def lenet5(num_classes: int = 10, include_loss: bool = False):
    """Inputs: data [N, 28, 28, 1] (+ label [N] when include_loss)."""
    specs = [
        LayerSpec("conv1", "Convolution", ("data",),
                  params=dict(num_output=20, kernel=5,
                              weight_filler={"type": "xavier"})),
        LayerSpec("pool1", "Pooling", ("conv1",), params=dict(kernel=2, stride=2)),
        LayerSpec("conv2", "Convolution", ("pool1",),
                  params=dict(num_output=50, kernel=5,
                              weight_filler={"type": "xavier"})),
        LayerSpec("pool2", "Pooling", ("conv2",), params=dict(kernel=2, stride=2)),
        LayerSpec("ip1", "InnerProduct", ("pool2",),
                  params=dict(num_output=500, weight_filler={"type": "xavier"})),
        LayerSpec("relu1", "ReLU", ("ip1",), tops=("ip1r",)),
        LayerSpec("ip2", "InnerProduct", ("ip1r",),
                  params=dict(num_output=num_classes,
                              weight_filler={"type": "xavier"})),
    ]
    if include_loss:
        specs += [
            LayerSpec("loss", "SoftmaxWithLoss", ("ip2", "label")),
            LayerSpec("accuracy", "Accuracy", ("ip2", "label"), phase="test"),
        ]
    else:
        specs += [LayerSpec("prob", "Softmax", ("ip2",))]
    return specs


INPUT_SHAPES = {"data": (64, 28, 28, 1)}
