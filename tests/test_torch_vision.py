"""The port's tools/vision.py (resize_image, oversample, Classifier,
Detector) against the JAX package's, on the same numpy images and the JAX
net's params carried over (``params_from_jax``): resize and oversample
exactly equal, the predictions within 1e-5 relative (f32 forwards of
one net, summed in another order). The counterparts of the vision cases
of tests/test_tools.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("PIL")

from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.tools import vision as jvision  # noqa: E402

from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net, params_from_jax  # noqa: E402
from caffe_escoin_tpu_torch.tools import vision  # noqa: E402

REL = 1e-5


def _nets(shape=(1, 28, 28, 1)):
    """(JAX net, its params, the port's net on the CPU, the same params)."""
    jnet = JNet(JZOO["lenet"][0]())
    jparams = jnet.init(jax.random.PRNGKey(0), {"data": shape})
    net = Net(ZOO["lenet"][0](), device="cpu")
    net.init(torch.Generator().manual_seed(0), {"data": shape})
    params, _ = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jnet, jparams, net, params


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= REL * np.linalg.norm(want)


def test_oversample_is_10_crops():
    rng = np.random.default_rng(0)
    ims = [rng.random((12, 12, 3)).astype(np.float32) for _ in range(2)]
    crops = vision.oversample(ims, (8, 8))
    assert crops.shape == (20, 8, 8, 3)
    np.testing.assert_array_equal(crops[9], crops[8][:, ::-1])
    np.testing.assert_array_equal(crops, jvision.oversample(ims, (8, 8)))


@pytest.mark.parametrize("shape,dims", [((10, 14, 3), (20, 28)),
                                        ((9, 9, 1), (5, 7)),
                                        ((6, 6, 3), (6, 6))])
def test_resize_image_is_the_jax_resize(shape, dims):
    im = np.random.default_rng(1).random(shape).astype(np.float32) * 3
    out = vision.resize_image(im, dims)
    assert out.shape == dims + shape[2:]
    np.testing.assert_array_equal(out, jvision.resize_image(im, dims))


@pytest.mark.parametrize("oversample_", [True, False])
def test_classifier_predict_matches_jax(oversample_):
    jnet, jparams, net, params = _nets()
    kw = dict(image_dims=(32, 32), mean=[0.25], raw_scale=2.0)
    rng = np.random.default_rng(2)
    ims = [rng.random((40, 40, 1)).astype(np.float32) for _ in range(2)]
    preds = vision.Classifier(net, params, **kw).predict(
        ims, oversample_=oversample_)
    want = jvision.Classifier(jnet, jparams, **kw).predict(
        ims, oversample_=oversample_)
    assert preds.shape == (2, 10)
    np.testing.assert_allclose(preds.sum(axis=1), 1.0, rtol=1e-4)
    _close(preds, want)


def test_classifier_on_logits_matches_jax():
    """A net whose final top is the logits (lenet without its Softmax):
    the averaged logits, which a near-uniform softmax would hide."""
    jnet, jparams, net, params = _nets()
    jnet = JNet(JZOO["lenet"][0]()[:-1])
    jnet.init(jax.random.PRNGKey(0), {"data": (1, 28, 28, 1)})
    net = Net(ZOO["lenet"][0]()[:-1], device="cpu")
    net.init(torch.Generator().manual_seed(0), {"data": (1, 28, 28, 1)})
    ims = [np.random.default_rng(3).random((32, 32, 1)).astype(np.float32)
           for _ in range(3)]
    got = vision.Classifier(net, params, output_name="ip2").predict(ims)
    want = jvision.Classifier(jnet, jparams, output_name="ip2").predict(ims)
    assert got.shape == (3, 10)
    _close(got, want)


def test_detector_windows_match_jax():
    jnet, jparams, net, params = _nets()
    im = np.random.default_rng(4).random((64, 64, 1)).astype(np.float32)
    windows = [(0, 0, 30, 30), (10, 10, 50, 50), (40, 20, 63, 60)]
    dets = vision.Detector(net, params, context_pad=2).detect_windows(
        [(im, windows)])
    want = jvision.Detector(jnet, jparams, context_pad=2).detect_windows(
        [(im, windows)])
    assert [d["window"] for d in dets] == windows
    for d, w in zip(dets, want):
        assert d["prediction"].shape == (10,)
        _close(d["prediction"], w["prediction"])
    assert vision.Detector(net, params).detect_windows([]) == []


def test_net_device_none_means_the_card(monkeypatch):
    """Net.device None is the card: without one the wrapper raises, and
    nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, net, params = _nets()
    net.device = None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.Classifier(net, params)
