"""The port's model zoo against the JAX package's (a mirror of
tests/test_model_zoo.py for the entries the port carries).

* Every ported ZOO entry builds, and its blob shapes and parameter shapes
  (grouped convs' [k, k, cin/group, cout] weights included) are the JAX
  net's at batch 1.
* The CaffeNet heads: 1000 classes, ``rcnn_ilsvrc13``'s 200 raw scores with
  no softmax, ``finetune_flickr_style``'s 20 classes.
* A 227x227 batch-1 CaffeNet forward (grouped conv2/4/5, LRN after the
  pools) on the JAX net's params against the JAX forward, dense f32: the
  logits within rtol 1e-4 and 1e-6 of their largest magnitude (sums in
  another order), the softmax rows summing to 1.
* ``include_loss=True`` names layer types the port has not registered yet
  (SoftmaxWithLoss, Accuracy): ``Net`` raises its KeyError and skips
  nothing.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.models import caffenet as jcaffenet  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402

from caffe_escoin_tpu_torch.models import (ZOO, alexnet, caffenet,  # noqa: E402
                                           googlenet)
from caffe_escoin_tpu_torch.nn import Net, params_from_jax  # noqa: E402


def _b1(input_shapes):
    return {k: (1,) + tuple(s[1:]) for k, s in input_shapes.items()}


def test_zoo_is_the_jax_zoo_but_lenet_and_cifar():
    assert set(ZOO) == set(JZOO) - {"lenet", "cifar10_quick", "cifar10_bn"}
    for name, (_, shapes) in ZOO.items():
        assert shapes == JZOO[name][1], name


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_builds_and_shapes_as_jax(name):
    builder, input_shapes = ZOO[name]
    shapes = _b1(input_shapes)
    net = Net(builder())
    params = net.init(torch.Generator().manual_seed(0), shapes)
    jnet = JNet(JZOO[name][0]())
    # shapes only: the JAX init traced, not run
    jparams = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                               shapes))
    assert net.blob_shapes == {k: tuple(v)
                               for k, v in jnet.blob_shapes.items()}
    assert [s.name for s in net.specs] == [s.name for s in jnet.specs]
    assert {k: {kk: tuple(vv.shape) for kk, vv in v.items()}
            for k, v in params.items()} == \
        {k: {kk: tuple(vv.shape) for kk, vv in v.items()}
         for k, v in jparams.items() if v}


def test_caffenet_head_shapes():
    net = Net(caffenet.caffenet(num_classes=1000))
    net.init(torch.Generator().manual_seed(0), {"data": (1, 227, 227, 3)})
    assert net.blob_shapes["prob"] == (1, 1000)
    # AlexNet's grouped conv2 holds half the input channels per group
    params = Net(alexnet.alexnet()).init(torch.Generator().manual_seed(0),
                                         {"data": (1, 227, 227, 3)})
    assert tuple(params["conv2"]["w"].shape) == (5, 5, 48, 256)
    assert tuple(params["conv4"]["w"].shape) == (3, 3, 192, 384)


def test_rcnn_raw_scores_no_softmax():
    specs = caffenet.rcnn_ilsvrc13()
    assert specs[-1].name == "fc-rcnn"
    assert "Softmax" not in {s.type for s in specs}
    net = Net(specs)
    net.init(torch.Generator().manual_seed(0), {"data": (1, 227, 227, 3)})
    assert net.blob_shapes["fc-rcnn"] == (1, 200)


def test_flickr_style_20_classes():
    net = Net(caffenet.finetune_flickr_style())
    net.init(torch.Generator().manual_seed(0), {"data": (1, 227, 227, 3)})
    assert net.blob_shapes["prob"] == (1, 20)


def test_caffenet_forward_matches_jax():
    jnet = JNet(jcaffenet.caffenet(num_classes=10))
    jparams = jnet.init(jax.random.PRNGKey(0), {"data": (1, 227, 227, 3)})
    params, _ = params_from_jax(jparams)
    x = np.random.default_rng(0).standard_normal((1, 227, 227, 3)).astype(
        np.float32) * 50.0
    want = jnet.apply(jparams, {"data": jnp.asarray(x)}, return_blobs=True)
    got = Net(caffenet.caffenet(num_classes=10)).apply(
        params, {"data": torch.from_numpy(x)}, return_blobs=True)
    ref = np.asarray(want["fc8"])
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got["fc8"].numpy(), ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max())
    assert got["prob"].shape == (1, 10)
    np.testing.assert_allclose(float(got["prob"].sum()), 1.0, rtol=1e-5)


@pytest.mark.parametrize("build", [
    alexnet.alexnet, caffenet.caffenet, googlenet.googlenet,
    caffenet.finetune_flickr_style])
def test_include_loss_names_types_the_port_has_not_registered(build):
    specs = build(include_loss=True)
    assert "SoftmaxWithLoss" in {s.type for s in specs}
    with pytest.raises(KeyError, match="not registered"):
        Net(specs, phase="train")
