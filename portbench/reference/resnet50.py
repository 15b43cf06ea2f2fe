"""ResNet-50 as published: He et al. 2015, "Deep Residual Learning for
Image Recognition", Table 1, in the form of the Caffe deploy prototxt of
KaimingHe/deep-residual-networks (ResNet-50-deploy.prototxt): a 7x7/2
stem, a 3x3/2 max pool, bottleneck blocks 3-4-6-3 with projection
shortcuts at each stage's start and the stride on the 1x1 ``branch2a``,
BatchNorm + Scale after every conv, a global average pool and fc1000.
Convs carry no bias; the fillers are msra (convs) and xavier (fc), as
the prototxt's training counterpart."""

from portbench.reference.plain import avg_pool_global, conv, fc, max_pool

STAGES = [  # (stage, blocks, mid channels, out channels, first stride)
    ("2", 3, 64, 256, 1),
    ("3", 4, 128, 512, 2),
    ("4", 6, 256, 1024, 2),
    ("5", 3, 512, 2048, 2),
]
MSRA = {"type": "msra"}


def table(num_classes: int = 1000):
    out = [conv("conv1", "data", 64, 7, stride=2, pad=3, bias=False, bn=True,
                weight_filler=MSRA),
           max_pool("pool1", "conv1", 3, 2)]
    bottom = "pool1"
    for stage, blocks, mid, cout, first in STAGES:
        for i in range(blocks):
            name = f"res{stage}{chr(ord('a') + i)}"
            stride = first if i == 0 else 1
            if i == 0:
                out.append(conv(f"{name}_branch1", bottom, cout, 1,
                                stride=stride, bias=False, bn=True,
                                relu=False, weight_filler=MSRA))
                shortcut = f"{name}_branch1"
            else:
                shortcut = bottom
            out += [
                conv(f"{name}_branch2a", bottom, mid, 1, stride=stride,
                     bias=False, bn=True, weight_filler=MSRA),
                conv(f"{name}_branch2b", f"{name}_branch2a", mid, 3, pad=1,
                     bias=False, bn=True, weight_filler=MSRA),
                # BatchNorm, then the shortcut added, then the ReLU
                conv(f"{name}_branch2c", f"{name}_branch2b", cout, 1,
                     bias=False, bn=True, residual=shortcut,
                     weight_filler=MSRA, top=name),
            ]
            bottom = name
    out += [avg_pool_global("pool5", bottom),
            fc("fc1000", "pool5", num_classes)]
    return out
