"""The CIFAR-10 nets (port of ``caffe_escoin_tpu/models/cifar.py``; the
same specs): the "quick" convnet of the reference's
`examples/cifar10/cifar10_quick_train_test.prototxt`, and its BatchNorm
variant.
"""

from __future__ import annotations

from caffe_escoin_tpu_torch.nn.net import LayerSpec


def cifar10_quick(num_classes: int = 10, include_loss: bool = False):
    """Inputs: data [N, 32, 32, 3] (+ label [N])."""
    specs = [
        LayerSpec("conv1", "Convolution", ("data",),
                  params=dict(num_output=32, kernel=5, pad=2,
                              weight_filler={"type": "gaussian", "std": 1e-4})),
        LayerSpec("pool1", "Pooling", ("conv1",),
                  params=dict(kernel=3, stride=2, mode="max")),
        LayerSpec("relu1", "ReLU", ("pool1",), tops=("pool1r",)),
        LayerSpec("conv2", "ConvolutionReLU", ("pool1r",),
                  params=dict(num_output=32, kernel=5, pad=2,
                              weight_filler={"type": "gaussian", "std": 0.01})),
        LayerSpec("pool2", "Pooling", ("conv2",),
                  params=dict(kernel=3, stride=2, mode="avg")),
        LayerSpec("conv3", "ConvolutionReLU", ("pool2",),
                  params=dict(num_output=64, kernel=5, pad=2,
                              weight_filler={"type": "gaussian", "std": 0.01})),
        LayerSpec("pool3", "Pooling", ("conv3",),
                  params=dict(kernel=3, stride=2, mode="avg")),
        LayerSpec("ip1", "InnerProduct", ("pool3",),
                  params=dict(num_output=64,
                              weight_filler={"type": "gaussian", "std": 0.1})),
        LayerSpec("ip2", "InnerProduct", ("ip1",),
                  params=dict(num_output=num_classes,
                              weight_filler={"type": "gaussian", "std": 0.1})),
    ]
    if include_loss:
        specs += [
            LayerSpec("loss", "SoftmaxWithLoss", ("ip2", "label")),
            LayerSpec("accuracy", "Accuracy", ("ip2", "label"), phase="test"),
        ]
    else:
        specs += [LayerSpec("prob", "Softmax", ("ip2",))]
    return specs


def cifar10_bn(num_classes: int = 10, include_loss: bool = False):
    """The reference's BatchNorm CIFAR variant
    (`examples/cifar10/cifar10_full_sigmoid_train_test_bn.prototxt`):
    conv -> pool -> BatchNorm -> Scale -> activation stacks. Inputs: data
    [N, 32, 32, 3] (+ label [N])."""
    def block(i, bottom, cout, act="ReLU"):
        return [
            LayerSpec(f"conv{i}", "Convolution", (bottom,),
                      params=dict(num_output=cout, kernel=5, pad=2,
                                  weight_filler={"type": "gaussian",
                                                 "std": 0.01})),
            LayerSpec(f"pool{i}", "Pooling", (f"conv{i}",),
                      params=dict(kernel=3, stride=2,
                                  mode="max" if i == 1 else "avg")),
            LayerSpec(f"bn{i}", "BatchNorm", (f"pool{i}",)),
            LayerSpec(f"scale{i}", "Scale", (f"bn{i}",),
                      params=dict(bias_term=True)),
            LayerSpec(f"act{i}", act, (f"scale{i}",), tops=(f"act{i}o",)),
        ]

    specs = (block(1, "data", 32) + block(2, "act1o", 32)
             + block(3, "act2o", 64))
    specs += [
        LayerSpec("ip1", "InnerProduct", ("act3o",),
                  params=dict(num_output=num_classes,
                              weight_filler={"type": "gaussian",
                                             "std": 0.01})),
    ]
    if include_loss:
        specs += [
            LayerSpec("loss", "SoftmaxWithLoss", ("ip1", "label")),
            LayerSpec("accuracy", "Accuracy", ("ip1", "label"),
                      phase="test"),
        ]
    else:
        specs += [LayerSpec("prob", "Softmax", ("ip1",))]
    return specs


INPUT_SHAPES = {"data": (64, 32, 32, 3)}
