"""The port's finite-difference gradient checker (``utils/gradient_check.py``)
on the cases of the JAX package's ``tests/test_gradient_check.py``, on the
port's ops and layers: a smooth function, a wrong gradient caught, ReLU and
PReLU with their kinks, the hinge and contrastive losses, Eltwise, and the
lenet ``Net.loss``. The checker's bound is the reference's scale-aware
``threshold * max(1, |analytic|, |estimated|)`` with ``threshold`` 1e-2
(2e-2 for the whole net, as the JAX test), and its finite differences agree
with the JAX checker's on the same inputs to atol 5e-4: a few f32 ulps of
the function's value (summed in another order) over 2 * eps = 2e-3.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.utils import gradient_check as jgc  # noqa: E402

from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net  # noqa: E402
from caffe_escoin_tpu_torch.ops import activations as act  # noqa: E402
from caffe_escoin_tpu_torch.ops import losses, structural  # noqa: E402
from caffe_escoin_tpu_torch.utils.gradient_check import (  # noqa: E402
    check_gradient, fd_gradients)


def _f32(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift
                             ).astype(np.float32))


def test_fd_estimator_on_a_smooth_fn_matches_jax(rng):
    x = _f32(rng, (3, 4))
    est = fd_gradients(lambda x: torch.sum(torch.sin(x) ** 2), (x,),
                       eps=1e-3)
    # f32 forward evaluations bound the estimate's own precision to ~1e-3
    np.testing.assert_allclose(est, (2 * torch.sin(x) * torch.cos(x)).numpy(),
                               atol=2e-3)
    jest = jgc.fd_gradients(lambda x: jnp.sum(jnp.sin(x) ** 2),
                            (jnp.asarray(x.numpy()),), eps=1e-3)
    np.testing.assert_allclose(est, jest, atol=5e-4)


def test_checker_catches_a_wrong_gradient(rng):
    class Broken(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return torch.sum(x * x)

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            return g * x  # missing the factor 2

    x = _f32(rng, (5,), shift=3.0)
    with pytest.raises(AssertionError, match="gradient mismatch"):
        check_gradient(Broken.apply, (x,))
    check_gradient(lambda x: torch.sum(x * x), (x,))


@pytest.mark.parametrize("slope", [0.0, 0.25])
def test_relu_gradient_with_kink(rng, slope):
    x = _f32(rng, (4, 6))
    check_gradient(lambda x: torch.sum(act.relu(x, slope) * 1.7), (x,),
                   kink=np.abs(x.numpy()), kink_range=1e-2)


def test_kink_range_that_excludes_everything_fails(rng):
    x = _f32(rng, (3,))
    with pytest.raises(AssertionError, match="excluded every element"):
        check_gradient(lambda x: torch.sum(act.relu(x)), (x,),
                       kink=np.zeros(3), kink_range=1.0)


def test_prelu_gradient_both_args(rng):
    x = _f32(rng, (4, 3, 3, 5))
    alpha = torch.from_numpy(rng.uniform(0.1, 0.4, 5).astype(np.float32))
    kink = np.abs(x.numpy())
    check_gradient(lambda x, a: torch.sum(act.prelu(x, a) ** 2), (x, alpha),
                   wrt=0, kink=kink, kink_range=1e-2)
    check_gradient(lambda x, a: torch.sum(act.prelu(x, a) ** 2), (x, alpha),
                   wrt=1)


@pytest.mark.parametrize("norm", ["L1", "L2"])
def test_hinge_loss_gradient(rng, norm):
    logits = _f32(rng, (6, 4), scale=2.0)
    labels = torch.from_numpy(rng.integers(0, 4, 6))
    lg = logits.numpy()
    true = lg[np.arange(6), labels.numpy()]
    kink = np.abs(1.0 + lg - true[:, None])
    check_gradient(lambda l: losses.hinge_loss(l, labels, norm=norm),
                   (logits,), kink=kink, kink_range=2e-2)


@pytest.mark.parametrize("legacy", [False, True])
def test_contrastive_loss_gradient(rng, legacy):
    a, b = _f32(rng, (8, 3)), _f32(rng, (8, 3))
    y = torch.from_numpy(rng.integers(0, 2, 8))
    d = np.linalg.norm((a - b).numpy(), axis=-1)
    dist = np.abs(1.0 - (d ** 2 if legacy else d))
    dist = np.where(y.numpy() == 1, np.inf, dist)
    kink = np.broadcast_to(dist[:, None], a.shape)
    for wrt in (0, 1):
        check_gradient(
            lambda a, b: losses.contrastive_loss(a, b, y,
                                                 legacy_version=legacy),
            (a, b), wrt=wrt, kink=kink, kink_range=5e-2)


@pytest.mark.parametrize("op", ["sum", "prod", "max"])
def test_eltwise_gradient(rng, op):
    x, y = _f32(rng, (3, 4)), _f32(rng, (3, 4))
    kink = np.abs((x - y).numpy()) if op == "max" else None
    coeffs = [0.7, -1.3] if op == "sum" else None
    for wrt in (0, 1):
        check_gradient(
            lambda a, b: torch.sum(
                structural.eltwise([a, b], op=op, coeffs=coeffs) ** 2),
            (x, y), wrt=wrt, kink=kink, kink_range=1e-2)


def test_lenet_net_loss_gradient(rng):
    """Whole-net check of Net.loss (loss_weight accumulation, conv, pool,
    relu, fc) on a small lenet, with respect to its small leaves."""
    net = Net(ZOO["lenet"][0](num_classes=4, include_loss=True))
    shapes = {"data": (2, 20, 20, 1), "label": (2,)}
    params = net.init(torch.Generator().manual_seed(0), shapes)
    data = _f32(rng, shapes["data"])
    label = torch.from_numpy(rng.integers(0, 4, 2))
    leaves = [(n, k) for n, blobs in params.items() for k in blobs
              if blobs[k].numel() <= 80]
    assert leaves, "expected at least one small leaf to check"

    def loss_wrt(name, key):
        def f(leaf):
            p = {n: dict(b) for n, b in params.items()}
            p[name][key] = leaf
            return net.loss(p, {"data": data, "label": label}, train=False)
        return f

    for name, key in leaves[:3]:
        check_gradient(loss_wrt(name, key), (params[name][key],), eps=5e-3,
                       threshold=2e-2)
