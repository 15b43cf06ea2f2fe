"""VGG-16 as published: Simonyan & Zisserman 2014, "Very Deep
Convolutional Networks for Large-Scale Image Recognition", Table 1,
configuration D, in the form of the Caffe model zoo's
VGG_ILSVRC_16_layers_deploy.prototxt: thirteen 3x3 convs with pad 1 and
stride 1 in five stages of 64, 128, 256, 512 and 512 channels, each conv
with a bias and a ReLU, a 2x2/2 max pool after each stage, then fc6 and
fc7 (4096, ReLU) and the classifier fc8. Dropout after fc6 and fc7 is the
identity at inference and is left out. The deploy prototxt names no
fillers: the convs take msra (which keeps the signal's scale through 13
ReLU convs without BatchNorm), the fcs xavier, every bias 0."""

from portbench.reference.plain import conv, fc, max_pool

STAGES = [  # (stage, channels of each conv)
    (1, [64, 64]),
    (2, [128, 128]),
    (3, [256, 256, 256]),
    (4, [512, 512, 512]),
    (5, [512, 512, 512]),
]
MSRA = {"type": "msra"}


def table(num_classes: int = 1000):
    out = []
    bottom = "data"
    for stage, chans in STAGES:
        for i, cout in enumerate(chans, 1):
            name = f"conv{stage}_{i}"
            out.append(conv(name, bottom, cout, 3, pad=1, weight_filler=MSRA))
            bottom = name
        out.append(max_pool(f"pool{stage}", bottom, 2, 2))
        bottom = f"pool{stage}"
    return out + [fc("fc6", bottom, 4096, relu=True),
                  fc("fc7", "fc6", 4096, relu=True),
                  fc("fc8", "fc7", num_classes)]
