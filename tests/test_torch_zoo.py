"""The port's model zoo against the JAX package's (a mirror of
tests/test_model_zoo.py).

* The port's ZOO is the JAX ZOO: the same ten entries and input shapes.
* Every entry builds, and its blob shapes and parameter shapes (grouped
  convs' [k, k, cin/group, cout] weights included) are the JAX net's at
  batch 1.
* The CaffeNet heads: 1000 classes, ``rcnn_ilsvrc13``'s 200 raw scores with
  no softmax, ``finetune_flickr_style``'s 20 classes.
* A 227x227 batch-1 CaffeNet forward (grouped conv2/4/5, LRN after the
  pools) on the JAX net's params against the JAX forward, dense f32: the
  logits within rtol 1e-4 and 1e-6 of their largest magnitude (sums in
  another order), the softmax rows summing to 1. lenet, cifar10_quick and
  cifar10_bn forwards at batch 2 against the JAX ones the same way (the
  cifar nets up to their average pools, whose divisor is Caffe's in the
  port).
* ``include_loss=True`` specs build and run forward in the TEST phase,
  giving the JAX loss and accuracy.
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


def test_zoo_is_the_jax_zoo():
    assert set(ZOO) == set(JZOO)
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


# the small nets' blobs compared with the JAX forward (the cifar nets'
# average pools take Caffe's divisor in the port)
SMALL = {"lenet": ("ip2", "prob"), "cifar10_quick": ("conv1", "pool1r",
                                                      "conv2"),
         "cifar10_bn": ("conv1", "act1o", "conv2")}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_net_forward_matches_jax(name):
    shapes = {"data": (2,) + tuple(ZOO[name][1]["data"][1:])}
    jnet = JNet(JZOO[name][0]())
    jparams = jnet.init(jax.random.PRNGKey(0), shapes)
    params, state = params_from_jax(jparams, jnet.state0)
    x = np.random.default_rng(0).standard_normal(shapes["data"]).astype(
        np.float32)
    want = jnet.apply(jparams, {"data": jnp.asarray(x)}, return_blobs=True)
    net = Net(ZOO[name][0]())
    net.init(torch.Generator().manual_seed(0), shapes)
    got = net(params, {"data": torch.from_numpy(x)}, state=state,
              return_blobs=True)
    assert set(got) == set(want)
    for blob in SMALL[name]:
        ref = np.asarray(want[blob])
        np.testing.assert_allclose(got[blob].numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("build", [
    alexnet.alexnet, caffenet.caffenet, googlenet.googlenet,
    caffenet.finetune_flickr_style])
def test_include_loss_specs_build_and_give_the_jax_loss(build):
    """Each model's TEST-phase net with its loss layers, at batch 4 on
    small maps (AlexNet's trunk still reaches pool5, GoogLeNet's global
    pool takes any size): it builds and runs, its loss and top-k
    accuracies are the JAX ops' (``ops/losses.py``) on the same logits,
    and the loss layer weighs 1.0 (the trunks are held to the JAX forward
    above and in test_torch_googlenet.py)."""
    from caffe_escoin_tpu.ops import losses as jlosses

    specs = build(include_loss=True)
    jspecs = JZOO[build.__name__][0](include_loss=True)
    net = Net(specs, phase="test")
    assert [s.name for s in net.specs] == [
        s.name for s in jspecs if s.phase in (None, "test")]
    side = 64 if build is googlenet.googlenet else 99
    shapes = {"data": (4, side, side, 3), "label": (4,)}
    params = net.init(torch.Generator().manual_seed(0), shapes)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shapes["data"]).astype(np.float32) * 50.0
    label = rng.integers(0, 10, 4).astype(np.int32)
    got = net(params, {"data": torch.from_numpy(x),
                       "label": torch.from_numpy(label)}, return_blobs=True)
    by_type = {}
    for s in net.specs:
        by_type.setdefault(s.type, []).append(s)
    (loss,) = by_type["SoftmaxWithLoss"]
    assert loss.loss_weight == 1.0
    logits = jnp.asarray(got[loss.bottoms[0]].numpy())
    np.testing.assert_allclose(
        got[loss.tops[0]].item(),
        float(jlosses.softmax_cross_entropy(logits, jnp.asarray(label))),
        rtol=1e-5)
    for acc in by_type.get("Accuracy", []):
        assert got[acc.tops[0]].item() == float(jlosses.accuracy(
            logits, jnp.asarray(label), top_k=acc.params.get("top_k", 1)))
