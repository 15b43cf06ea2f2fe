"""AlexNet as published: Krizhevsky, Sutskever & Hinton 2012, "ImageNet
Classification with Deep Convolutional Neural Networks" (NIPS 2012), in
the form of BVLC's models/bvlc_alexnet/deploy.prototxt: an 11x11/4 conv
of 96 on the 227x227x3 image, LRN (5, 1e-4, 0.75) and a 3x3/2 max pool;
a 5x5 conv of 256 in 2 groups, LRN and a 3x3/2 max pool; 3x3 convs of
384, 384 (2 groups) and 256 (2 groups), a 3x3/2 max pool; fc6 and fc7
(4096, ReLU) and the classifier fc8. Every conv and fc has a bias, every
conv a ReLU, and each LRN follows its conv's ReLU (BVLC's order:
conv, ReLU, LRN, pool).

Departures: dropout after fc6 and fc7 is the identity at inference and is
left out. The deploy prototxt names no fillers: the convs take msra
(which keeps the signal's scale through the convs without BatchNorm),
the fcs xavier; the biases are train_val.prototxt's constants, 0.1 on
conv2, conv4, conv5, fc6 and fc7 and 0 on conv1, conv3 and fc8."""

from portbench.reference.plain import conv, fc, lrn, max_pool

MSRA = {"type": "msra"}
BIAS = {"type": "constant", "value": 0.1}


def _conv(name, bottom, cout, k, *, stride=1, pad=0, group=1, bias=False):
    return conv(name, bottom, cout, k, stride=stride, pad=pad, group=group,
                weight_filler=MSRA, bias_filler=BIAS if bias else None)


def table(num_classes: int = 1000):
    return [
        _conv("conv1", "data", 96, 11, stride=4),
        lrn("norm1", "conv1"),
        max_pool("pool1", "norm1", 3, 2),
        _conv("conv2", "pool1", 256, 5, pad=2, group=2, bias=True),
        lrn("norm2", "conv2"),
        max_pool("pool2", "norm2", 3, 2),
        _conv("conv3", "pool2", 384, 3, pad=1),
        _conv("conv4", "conv3", 384, 3, pad=1, group=2, bias=True),
        _conv("conv5", "conv4", 256, 3, pad=1, group=2, bias=True),
        max_pool("pool5", "conv5", 3, 2),
        fc("fc6", "pool5", 4096, relu=True, bias_filler=BIAS),
        fc("fc7", "fc6", 4096, relu=True, bias_filler=BIAS),
        fc("fc8", "fc7", num_classes),
    ]
