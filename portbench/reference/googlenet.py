"""GoogLeNet (Inception v1) as published: Szegedy et al. 2014, "Going
Deeper with Convolutions", Table 1, in the form of BVLC's
models/bvlc_googlenet/deploy.prototxt: the inference graph, without the
two auxiliary heads. Every conv has a bias and a ReLU; LRN (5, 1e-4,
0.75) after the first max pool and after conv2/3x3; four-branch inception
modules joined by Concat; a 7x7 average pool over the 7x7 map (global),
dropout (the identity at inference) and the classifier. Fillers as the
training prototxt: xavier weights, conv biases constant 0.2, the
classifier's bias 0."""

from portbench.reference.plain import (avg_pool_global, concat, conv, fc, lrn,
                                       max_pool)

INCEPTION = [  # (name, 1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool proj)
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
BIAS = {"type": "constant", "value": 0.2}
POOL_AFTER = {"3b": "pool3/3x3_s2", "4e": "pool4/3x3_s2"}


def _conv(name, bottom, cout, k, stride=1, pad=0):
    return conv(name, bottom, cout, k, stride=stride, pad=pad,
                bias_filler=BIAS)


def table(num_classes: int = 1000):
    out = [_conv("conv1/7x7_s2", "data", 64, 7, 2, 3),
           max_pool("pool1/3x3_s2", "conv1/7x7_s2", 3, 2),
           lrn("pool1/norm1", "pool1/3x3_s2"),
           _conv("conv2/3x3_reduce", "pool1/norm1", 64, 1),
           _conv("conv2/3x3", "conv2/3x3_reduce", 192, 3, pad=1),
           lrn("conv2/norm2", "conv2/3x3"),
           max_pool("pool2/3x3_s2", "conv2/norm2", 3, 2)]
    bottom = "pool2/3x3_s2"
    for name, c1, r3, c3, r5, c5, pp in INCEPTION:
        p = f"inception_{name}"
        out += [
            _conv(f"{p}/1x1", bottom, c1, 1),
            _conv(f"{p}/3x3_reduce", bottom, r3, 1),
            _conv(f"{p}/3x3", f"{p}/3x3_reduce", c3, 3, pad=1),
            _conv(f"{p}/5x5_reduce", bottom, r5, 1),
            _conv(f"{p}/5x5", f"{p}/5x5_reduce", c5, 5, pad=2),
            max_pool(f"{p}/pool", bottom, 3, 1, 1),
            _conv(f"{p}/pool_proj", f"{p}/pool", pp, 1),
            concat(f"{p}/output", [f"{p}/1x1", f"{p}/3x3", f"{p}/5x5",
                                   f"{p}/pool_proj"]),
        ]
        bottom = f"{p}/output"
        if name in POOL_AFTER:
            out.append(max_pool(POOL_AFTER[name], bottom, 3, 2))
            bottom = POOL_AFTER[name]
    out += [avg_pool_global("pool5/7x7_s1", bottom),
            fc("loss3/classifier", "pool5/7x7_s1", num_classes)]
    return out
