"""The six losses the training port adds (``ops/losses.py``) and their
layers, against the JAX package's: each forward, and its gradient
(``torch.autograd.grad``) against ``jax.grad`` with respect to every float
input, on the same numpy inputs made from a seed. Tolerance: rtol 1e-5,
atol 1e-6 (f32; the same formulas).

Also the layers: a loss layer without a ``loss_weight`` takes 1.0, its top
is a scalar, and ``Net.loss`` sums the weighted loss tops as the JAX
``Net.loss`` does.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.nn import LayerSpec as JSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.ops import losses as jlosses  # noqa: E402

from caffe_escoin_tpu_torch.nn import LayerSpec, Net  # noqa: E402
from caffe_escoin_tpu_torch.ops import losses  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
N, C = 6, 5


def _inputs(name, rng):
    """(float args, int/label args, kwargs) of each loss."""
    logits = rng.standard_normal((N, C)).astype(np.float32) * 2
    labels = rng.integers(0, C, N).astype(np.int32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if name == "sigmoid_cross_entropy":
        return [logits, rng.random((N, C)).astype(np.float32)], [], {}
    if name == "euclidean_loss":
        return [rng.standard_normal((N, 2, 3)).astype(np.float32),
                rng.standard_normal((N, 2, 3)).astype(np.float32)], [], {}
    if name in ("hinge_loss_L1", "hinge_loss_L2"):
        return [logits], [labels], {"norm": name[-2:]}
    if name == "multinomial_logistic_loss":
        return [probs.astype(np.float32)], [labels], {}
    if name == "infogain_loss":
        h = rng.random((C, C)).astype(np.float32)
        return [probs.astype(np.float32)], [labels, h], {}
    a = rng.standard_normal((N, 4)).astype(np.float32)
    b = rng.standard_normal((N, 4)).astype(np.float32) * 0.5
    sim = rng.integers(0, 2, N).astype(np.int32)
    return [a, b], [sim], {"legacy_version": name.endswith("legacy"),
                           "margin": 2.0}


NAMES = ["sigmoid_cross_entropy", "euclidean_loss", "hinge_loss_L1",
         "hinge_loss_L2", "multinomial_logistic_loss", "infogain_loss",
         "contrastive_loss", "contrastive_loss_legacy"]


def _fn(mod, name):
    base = name.replace("_L1", "").replace("_L2", "").replace("_legacy", "")
    return getattr(mod, base)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradient_match_jax(name):
    floats, rest, kw = _inputs(name, np.random.default_rng(0))
    jf = _fn(jlosses, name)
    want = jf(*map(jnp.asarray, floats), *map(jnp.asarray, rest), **kw)
    jgrads = jax.grad(lambda *fl: jf(*fl, *map(jnp.asarray, rest), **kw),
                      argnums=tuple(range(len(floats))))(
        *map(jnp.asarray, floats))
    ts = [torch.from_numpy(f).requires_grad_() for f in floats]
    got = _fn(losses, name)(*ts, *map(torch.from_numpy, rest), **kw)
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    tgrads = torch.autograd.grad(got, ts)
    for g, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL)


LAYERS = {  # type -> (bottom names, the _inputs case, params)
    "SigmoidCrossEntropyLoss": (("x", "t"), "sigmoid_cross_entropy", {}),
    "EuclideanLoss": (("x", "t"), "euclidean_loss", {}),
    "HingeLoss": (("x", "label"), "hinge_loss_L2", {"norm": "L2"}),
    "MultinomialLogisticLoss": (("x", "label"), "multinomial_logistic_loss",
                                {}),
    "InfogainLoss": (("x", "label"), "multinomial_logistic_loss", {}),
    "ContrastiveLoss": (("x", "t", "sim"), "contrastive_loss_legacy",
                        {"legacy_version": True, "margin": 2.0}),
}


@pytest.mark.parametrize("kind", list(LAYERS))
def test_loss_layers_match_jax_through_net_loss(kind):
    """Each layer with its default loss weight 1.0 (InfogainLoss without
    an H is the multinomial logistic loss), and with weight 0.5 beside a
    second loss: Net.loss sums them as the JAX Net does; its gradient
    matches jax.grad's."""
    bottoms, case, params = LAYERS[kind]
    floats, rest, _ = _inputs(case, np.random.default_rng(1))
    feed = dict(zip(bottoms, floats + rest))
    results = []
    for spec_cls, net_cls in ((LayerSpec, Net), (JSpec, JNet)):
        specs = [spec_cls("loss", kind, bottoms, params=params),
                 spec_cls("l2", "EuclideanLoss", ("x", "x0"),
                          loss_weight=0.5)]
        results.append((specs, net_cls(specs, phase="train")))
    (specs, net), (jspecs, jnet) = results
    assert specs[0].loss_weight == jspecs[0].loss_weight == 1.0
    feed["x0"] = np.zeros_like(feed["x"])
    tfeed = {k: torch.from_numpy(v) for k, v in feed.items()}
    x = tfeed["x"].requires_grad_()
    got = net.loss({}, tfeed)
    (gx,) = torch.autograd.grad(got, x)
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
    want = jnet.loss({}, jfeed)
    jgx = jax.grad(lambda xx: jnet.loss({}, {**jfeed, "x": xx}))(jfeed["x"])
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)
    assert net.layers[0].out_shapes([f.shape for f in floats + rest]) == [()]


def test_infogain_layer_takes_its_h():
    rng = np.random.default_rng(2)
    floats, rest, _ = _inputs("infogain_loss", rng)
    (probs,), (labels, h) = floats, rest
    net = Net([LayerSpec("loss", "InfogainLoss", ("p", "label"),
                         params={"infogain": h})], phase="train")
    got = net.loss({}, {"p": torch.from_numpy(probs),
                        "label": torch.from_numpy(labels)})
    np.testing.assert_allclose(got.item(), float(jlosses.infogain_loss(
        jnp.asarray(probs), jnp.asarray(labels), jnp.asarray(h))), rtol=RTOL)
