"""Training-mode BatchNorm and Dropout in the port.

BatchNorm: the training forward and the moving-average recursion over three
steps against the JAX layer, on rank-4 (NHWC) and rank-2 inputs, through
``Net.forward(train=True, return_state=True)`` and the layer; then
inference on the learned statistics. Tolerance rtol 1e-5, atol 1e-6 (f32,
the same formulas; the sums advance acc = lam*acc + stat with the variance
bias-corrected by m/(m-1)). The new state never carries autograd history.

Dropout: the two packages' random generators differ, so it is held to
properties: the identity at test and at ratio 0, survivors exactly
x/(1-p), the zero share within a binomial 5-sigma bound, the same mask for
the same generator seed, and a training forward without a generator
raises, as the JAX one does without an rng key (the mask on a CUDA
generator: tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import (  # noqa: E402
    ExecutionPolicy as JPolicy)
from caffe_escoin_tpu.nn import LayerSpec as JSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.net import LAYER_REGISTRY as JREG  # noqa: E402
from caffe_escoin_tpu.ops import norm as jnorm  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy  # noqa
from caffe_escoin_tpu_torch.nn import LayerSpec, Net  # noqa: E402
from caffe_escoin_tpu_torch.nn.net import LAYER_REGISTRY  # noqa: E402
from caffe_escoin_tpu_torch.ops import activations as act  # noqa: E402
from caffe_escoin_tpu_torch.ops import norm  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _bn_nets(lam):
    out = []
    for spec_cls, net_cls in ((LayerSpec, Net), (JSpec, JNet)):
        out.append(net_cls([
            spec_cls("data", "Input"),
            spec_cls("bn", "BatchNorm", ("data",),
                     params=dict(moving_average_fraction=lam)),
        ], phase="train"))
    return out


@pytest.mark.parametrize("shape", [(6, 3, 3, 4), (16, 6)])
def test_bn_training_forward_and_recursion_match_jax(shape):
    lam = 0.7
    net, jnet = _bn_nets(lam)
    gen = torch.Generator().manual_seed(0)
    _, state = net.init_with_state(gen, {"data": shape})
    _, jstate = jnet.init_with_state(jax.random.PRNGKey(0), {"data": shape})
    rng = np.random.default_rng(0)
    for t in range(3):
        x = (rng.standard_normal(shape) * (t + 1) + t).astype(np.float32)
        xt = torch.from_numpy(x).requires_grad_()
        out, new = net.forward({}, {"data": xt}, train=True, state=state,
                               return_state=True)
        jout, jstate = jnet.apply({}, {"data": jnp.asarray(x)}, train=True,
                                  state=jstate, return_state=True)
        assert new is not state and new["bn"] is not state["bn"]
        assert not any(v.requires_grad for v in new["bn"].values())
        np.testing.assert_allclose(out["bn"].detach().numpy(),
                                   np.asarray(jout["bn"]), rtol=RTOL,
                                   atol=ATOL)
        _close({k: v.numpy() for k, v in new["bn"].items()}, jstate["bn"])
        state = new
    assert float(state["bn"]["count"]) == pytest.approx(1 + lam + lam ** 2)
    # inference divides the learned sums by the count
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 1
    got = net.forward({}, {"data": torch.from_numpy(x)}, state=state)["bn"]
    want = jnet.apply({}, {"data": jnp.asarray(x)}, state=jstate)["bn"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("use_global", [None, True, False])
@pytest.mark.parametrize("train", [False, True])
def test_bn_layer_use_global_stats_matches_jax(use_global, train):
    """``use_global_stats`` None means "not in training"; True pins the
    moving statistics in training too (state unchanged), False the batch
    statistics at test too (no new state outside training)."""
    params = {} if use_global is None else {"use_global_stats": use_global}
    layer = LAYER_REGISTRY["BatchNorm"](
        LayerSpec("bn", "BatchNorm", ("x",), params=params),
        ExecutionPolicy())
    jlayer = JREG["BatchNorm"](JSpec("bn", "BatchNorm", ("x",),
                                     params=params), JPolicy())
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 5)).astype(np.float32) * 3 + 1
    st = {"mean_acc": rng.random(5).astype(np.float32),
          "var_acc": rng.random(5).astype(np.float32) + 1,
          "count": np.float32(1.5)}
    jouts, jnew = jlayer.apply_stateful(
        {}, {k: jnp.asarray(v) for k, v in st.items()}, [jnp.asarray(x)],
        train=train, rng=None)
    tst = {k: torch.tensor(v) for k, v in st.items()}
    res = layer({}, [torch.from_numpy(x)], tst, train=train)
    outs, new = res if train else (res, tst)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(jouts[0]),
                               rtol=RTOL, atol=ATOL)
    if train:
        _close({k: v.numpy() for k, v in new.items()}, jnew)


def test_batch_norm_ops_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3, 3, 6)).astype(np.float32) * 2 + 0.5
    got = norm.batch_norm_train(torch.from_numpy(x))
    want = jnorm.batch_norm_train(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    mean, var, gamma, beta = (rng.random(6).astype(np.float32) + 0.1
                              for _ in range(4))
    for args in ((mean, var), (mean, var, gamma, beta)):
        np.testing.assert_allclose(
            norm.batch_norm(torch.from_numpy(x),
                            *map(torch.from_numpy, args)).numpy(),
            np.asarray(jnorm.batch_norm(jnp.asarray(x),
                                        *map(jnp.asarray, args))),
            rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Dropout


def _x(shape=(64, 256)):
    return torch.from_numpy(np.random.default_rng(3).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("ratio", [0.5, 0.0])
def test_dropout_identity_at_test_and_at_ratio_zero(ratio):
    x = _x()
    gen = torch.Generator().manual_seed(0)
    assert act.dropout(x, ratio, generator=gen) is x
    if ratio == 0.0:
        assert act.dropout(x, ratio, generator=gen, train=True) is x
    net = Net([LayerSpec("drop", "Dropout", ("x",),
                         params=dict(ratio=ratio))], phase="train")
    assert torch.equal(net.forward({}, {"x": x})["drop"], x)


@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.9])
def test_dropout_survivors_and_zero_share(ratio):
    x = _x()
    out = act.dropout(x, ratio, generator=torch.Generator().manual_seed(1),
                      train=True)
    kept = out != 0
    np.testing.assert_array_equal(
        out[kept].numpy(), x[kept].numpy() / np.float32(1.0 - ratio))
    n = x.numel()
    share = 1.0 - kept.float().mean().item()
    assert abs(share - ratio) <= 5 * np.sqrt(ratio * (1 - ratio) / n)


def test_dropout_same_seed_same_mask_through_the_net():
    net = Net([LayerSpec("drop", "Dropout", ("x",), params=dict(ratio=0.3)),
               LayerSpec("drop2", "Dropout", ("drop",),
                         params=dict(ratio=0.3))], phase="train")
    x = _x((8, 32))
    outs = [net.forward({}, {"x": x}, train=True,
                        generator=torch.Generator().manual_seed(s))["drop2"]
            for s in (7, 7, 8)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="generator"):
        net.forward({}, {"x": x}, train=True)
