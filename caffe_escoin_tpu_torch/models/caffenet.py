"""CaffeNet and its derived deploy nets.

Port of ``caffe_escoin_tpu/models/caffenet.py``: the same specs.

* ``caffenet``: `models/bvlc_reference_caffenet/deploy.prototxt` — AlexNet
  with the pool/norm order swapped (conv1 -> relu1 -> pool1 -> norm1,
  vs AlexNet's conv1 -> relu1 -> norm1 -> pool1).
* ``rcnn_ilsvrc13``: `models/bvlc_reference_rcnn_ilsvrc13/deploy.prototxt`
  — the CaffeNet trunk ending at the 200-way `fc-rcnn` head with NO softmax
  (R-CNN consumes raw SVM-style scores).
* ``finetune_flickr_style``: `models/finetune_flickr_style/deploy.prototxt`
  — CaffeNet with a re-initialized 20-way `fc8_flickr` head.
"""

from __future__ import annotations

from caffe_escoin_tpu_torch.nn.net import LayerSpec


def _trunk(fuse_relu: bool):
    """conv1..fc7d of CaffeNet (pool-before-norm order)."""
    conv_type = "ConvolutionReLU" if fuse_relu else "Convolution"

    def conv(name, bottom, cout, k, s=1, p=0, group=1):
        return LayerSpec(name, conv_type, (bottom,),
                         params=dict(num_output=cout, kernel=k, stride=s,
                                     pad=p, group=group,
                                     weight_filler={"type": "gaussian",
                                                    "std": 0.01}))

    return [
        conv("conv1", "data", 96, 11, s=4),
        LayerSpec("pool1", "Pooling", ("conv1",),
                  params=dict(kernel=3, stride=2)),
        LayerSpec("norm1", "LRN", ("pool1",),
                  params=dict(local_size=5, alpha=1e-4, beta=0.75)),
        conv("conv2", "norm1", 256, 5, p=2, group=2),
        LayerSpec("pool2", "Pooling", ("conv2",),
                  params=dict(kernel=3, stride=2)),
        LayerSpec("norm2", "LRN", ("pool2",),
                  params=dict(local_size=5, alpha=1e-4, beta=0.75)),
        conv("conv3", "norm2", 384, 3, p=1),
        conv("conv4", "conv3", 384, 3, p=1, group=2),
        conv("conv5", "conv4", 256, 3, p=1, group=2),
        LayerSpec("pool5", "Pooling", ("conv5",),
                  params=dict(kernel=3, stride=2)),
        LayerSpec("fc6", "InnerProduct", ("pool5",),
                  params=dict(num_output=4096,
                              weight_filler={"type": "gaussian",
                                             "std": 0.005})),
        LayerSpec("relu6", "ReLU", ("fc6",), tops=("fc6r",)),
        LayerSpec("drop6", "Dropout", ("fc6r",), tops=("fc6d",),
                  params=dict(ratio=0.5)),
        LayerSpec("fc7", "InnerProduct", ("fc6d",),
                  params=dict(num_output=4096,
                              weight_filler={"type": "gaussian",
                                             "std": 0.005})),
        LayerSpec("relu7", "ReLU", ("fc7",), tops=("fc7r",)),
        LayerSpec("drop7", "Dropout", ("fc7r",), tops=("fc7d",),
                  params=dict(ratio=0.5)),
    ]


def caffenet(num_classes: int = 1000, include_loss: bool = False,
             fuse_relu: bool = True):
    """Inputs: data [N, 227, 227, 3] (+ label [N])."""
    specs = _trunk(fuse_relu)
    specs.append(LayerSpec("fc8", "InnerProduct", ("fc7d",),
                           params=dict(num_output=num_classes,
                                       weight_filler={"type": "gaussian",
                                                      "std": 0.01})))
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


def rcnn_ilsvrc13(fuse_relu: bool = True):
    """200-way detection-score head, no softmax (deploy.prototxt:196-207)."""
    specs = _trunk(fuse_relu)
    specs.append(LayerSpec("fc-rcnn", "InnerProduct", ("fc7d",),
                           params=dict(num_output=200,
                                       weight_filler={"type": "gaussian",
                                                      "std": 0.01})))
    return specs


def finetune_flickr_style(include_loss: bool = False, fuse_relu: bool = True):
    """20-way style classifier head (`finetune_flickr_style/deploy.prototxt`)."""
    specs = _trunk(fuse_relu)
    specs.append(LayerSpec("fc8_flickr", "InnerProduct", ("fc7d",),
                           params=dict(num_output=20,
                                       weight_filler={"type": "gaussian",
                                                      "std": 0.01})))
    if include_loss:
        specs.append(LayerSpec("loss", "SoftmaxWithLoss",
                               ("fc8_flickr", "label")))
    else:
        specs.append(LayerSpec("prob", "Softmax", ("fc8_flickr",)))
    return specs


INPUT_SHAPES = {"data": (32, 227, 227, 3)}
