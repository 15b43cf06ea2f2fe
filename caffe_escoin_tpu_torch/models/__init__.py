from caffe_escoin_tpu_torch.models import (alexnet, caffenet,  # noqa: F401
                                           cifar, googlenet, lenet, resnet,
                                           vgg)

# name -> (spec builder, input shapes): the JAX package's ZOO
ZOO = {
    "lenet": (lenet.lenet5, lenet.INPUT_SHAPES),
    "cifar10_quick": (cifar.cifar10_quick, cifar.INPUT_SHAPES),
    "cifar10_bn": (cifar.cifar10_bn, cifar.INPUT_SHAPES),
    "alexnet": (alexnet.alexnet, alexnet.INPUT_SHAPES),
    "vgg16": (vgg.vgg16, vgg.INPUT_SHAPES),
    "googlenet": (googlenet.googlenet, googlenet.INPUT_SHAPES),
    "resnet50": (resnet.resnet50, resnet.INPUT_SHAPES),
    "caffenet": (caffenet.caffenet, caffenet.INPUT_SHAPES),
    "rcnn_ilsvrc13": (caffenet.rcnn_ilsvrc13, caffenet.INPUT_SHAPES),
    "finetune_flickr_style": (caffenet.finetune_flickr_style,
                              caffenet.INPUT_SHAPES),
}
