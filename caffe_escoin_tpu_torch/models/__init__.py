from caffe_escoin_tpu_torch.models import resnet, vgg  # noqa: F401

# the models the port carries so far (name -> (spec builder, input shapes)),
# a subset of the JAX package's ZOO
ZOO = {
    "vgg16": (vgg.vgg16, vgg.INPUT_SHAPES),
    "resnet50": (resnet.resnet50, resnet.INPUT_SHAPES),
}
