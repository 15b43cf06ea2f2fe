"""The port's per-layer timing report (``utils/timing.py``) against the JAX
package's.

* ``format_report`` gives the JAX text for the same result dict (forward
  only, and with the backward column and the sparse rows' rates).
* ``time_net_layerwise(backward=True)`` on cifar10_quick b2, weights pruned
  to 90% in 128x128 blocks, at conv_mode 0 (dense) and 3 (aligned,
  SCONV_PAR): the JAX function's rows, types and categories, the same set
  of rows with a backward time (none for a conv aligned with a BSC, as the
  JAX ``jax.grad`` over its int32 index leaves raises), the same ``nnz`` on
  the sparse rows; the sum of every bucket is its rows'.
* The backward of a sparse fc through the XBSP ``spmm`` gives the dense
  gradient, in f32 and bf16 (its arms stay differentiable with grad
  enabled).
* ``debug_info`` gives the JAX rows within 1e-5 (ResNet-50's stem and
  stage 2 with a BatchNorm state; the cifar nets' average pools take
  Caffe's divisor in the port, not the JAX package's).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.engine.context import ConvMode as JMode  # noqa: E402
from caffe_escoin_tpu.engine.context import \
    ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.utils import timing as jtiming  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import (ConvMode,  # noqa: E402
                                                   ExecutionPolicy)
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs  # noqa: E402
from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net, params_from_jax  # noqa: E402
from caffe_escoin_tpu_torch.sparse import dense_to_bsc  # noqa: E402
from caffe_escoin_tpu_torch.utils import timing  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,  # noqa: E402
                                                  prune_conv_weight)

BLOCK = (128, 128)


def _result(backward):
    rows = [{"name": "conv1", "type": "Convolution", "category": "conv",
             "ms": 0.25, "nnz": 300, "gflops": 12.5, "nnz_per_s": 6.2e9},
            {"name": "res2a_branch2a_relu", "type": "ReLU",
             "category": "other", "ms": 1.5},
            {"name": "ip1", "type": "InnerProduct", "category": "fc",
             "ms": 0.125}]
    cats = {"conv": 0.25, "fc": 0.125, "data": 0.0, "other": 1.5}
    out = {"layers": rows, "categories": cats, "total_ms": 1.875}
    if backward:
        for r, b in zip(rows, (0.0, 2.25, 0.5)):
            r["bwd_ms"] = b
        out["categories_backward"] = {"conv": 0.0, "fc": 0.5, "data": 0.0,
                                      "other": 2.25}
        out["total_backward_ms"] = 2.75
    return out


@pytest.mark.parametrize("backward", [False, True])
def test_format_report_is_the_jax_text(backward):
    assert timing.format_report(_result(backward)) == \
        jtiming.format_report(_result(backward))


def _pruned(jnet, jparams):
    out = dict(jparams)
    for layer in jnet.layers:
        n = layer.spec.name
        if layer.spec.type in ("Convolution", "ConvolutionReLU"):
            w = np.asarray(out[n]["w"])
            if w.shape[0] * w.shape[1] * w.shape[2] >= 32:
                out[n] = dict(out[n], w=prune_conv_weight(w, 0.9, BLOCK))
    return out


@pytest.mark.parametrize("mode", [0, 3])
def test_layerwise_rows_are_the_jax_rows(mode):
    shapes = {"data": (2, 32, 32, 3)}
    jnet = JNet(JZOO["cifar10_quick"][0](), policy=JPolicy(
        conv_mode=JMode(mode), block_shape=BLOCK))
    jparams = _pruned(jnet, jnet.init(jax.random.PRNGKey(0), shapes))
    net = Net(ZOO["cifar10_quick"][0](), policy=ExecutionPolicy(
        conv_mode=ConvMode(mode), block_shape=BLOCK))
    net.init(torch.Generator().manual_seed(0), shapes)
    params, _ = params_from_jax(jparams)
    if mode:
        jparams, params = jnet.weight_align(jparams), net.weight_align(params)
    x = np.random.default_rng(0).standard_normal(shapes["data"]).astype(
        np.float32)
    want = jtiming.time_net_layerwise(jnet, jparams, {"data": x}, iters=1,
                                      backward=True)
    got = timing.time_net_layerwise(net, params,
                                    {"data": torch.from_numpy(x)}, iters=1,
                                    backward=True)

    def rows(res, key):
        return [(r["name"], r["type"], r["category"], r.get(key))
                for r in res["layers"]]

    assert rows(got, "nnz") == rows(want, "nnz")
    timed = {r["name"] for r in got["layers"] if r["bwd_ms"] > 0}
    assert timed == {r["name"] for r in want["layers"] if r["bwd_ms"] > 0}
    convs = {r["name"] for r in got["layers"] if r["category"] == "conv"}
    assert (convs & timed == set()) == bool(mode)
    for key, total in (("categories", "ms"),
                       ("categories_backward", "bwd_ms")):
        for cat, t in got[key].items():
            assert t == pytest.approx(sum(r[total] for r in got["layers"]
                                          if r["category"] == cat))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_fc_backward_is_the_dense_gradient(dtype):
    rng = np.random.default_rng(0)
    w = prune_blocks(rng.standard_normal((256, 96)).astype(np.float32), 0.5,
                     (64, 32))
    bsc = dense_to_bsc(w, (64, 32))
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    blocks = bsc.blocks.to(dtype).requires_grad_(True)
    xs = x.to(dtype).requires_grad_(True)

    got = xbs.spmm(xs, dataclasses.replace(bsc, blocks=blocks))
    gx, gb = torch.autograd.grad(got.float().sum(), [xs, blocks])
    wd = torch.from_numpy(w).to(dtype).float().requires_grad_(True)
    xd = x.to(dtype).float().requires_grad_(True)
    ref = xd @ wd
    rx, rw = torch.autograd.grad(ref.sum(), [xd, wd])
    # f32 sums in another order; in bf16 each block column's share of a
    # gradient is rounded to bf16 before the shares add up
    tol = 1e-5 if dtype == torch.float32 else 1e-2

    def close(a, b):
        torch.testing.assert_close(a.float(), b, rtol=tol,
                                   atol=tol * b.abs().max().item())

    close(got, ref)
    close(gx, rx)
    # each live block's gradient is the dense gradient's block
    dense_grad = dataclasses.replace(bsc, blocks=gb.float()).to_dense()
    live = torch.from_numpy(w != 0)
    close(dense_grad[live], rw[live])


def _res2(specs):
    """ResNet-50's stem and stage 2 (the specs up to res3)."""
    return specs[:next(i for i, s in enumerate(specs)
                       if s.name.startswith("res3"))]


def test_debug_info_rows_are_the_jax_rows():
    shapes = {"data": (1, 32, 32, 3)}
    jnet = JNet(_res2(JZOO["resnet50"][0]()))
    jparams = jnet.init(jax.random.PRNGKey(0), shapes)
    rng = np.random.default_rng(1)
    jstate = {k: {"mean_acc": rng.standard_normal(v["mean_acc"].shape
                                                  ).astype(np.float32),
                  "var_acc": rng.uniform(0.5, 2.0, v["var_acc"].shape
                                         ).astype(np.float32),
                  "count": np.float32(2.0)}
              for k, v in jnet.state0.items()}
    net = Net(_res2(ZOO["resnet50"][0]()))
    net.init(torch.Generator().manual_seed(0), shapes)
    params, state = params_from_jax(jparams, jstate)
    x = rng.standard_normal(shapes["data"]).astype(np.float32)
    want = jtiming.debug_info(jnet, jparams, {"data": x}, state=jstate,
                              log=lambda *_: None)
    got = timing.debug_info(net, params, {"data": torch.from_numpy(x)},
                            state=state, log=lambda *_: None)
    assert [{k: v for k, v in r.items() if k != "data"} for r in got] == \
        [{k: v for k, v in r.items() if k != "data"} for r in want]
    np.testing.assert_allclose([r["data"] for r in got],
                               [r["data"] for r in want], rtol=1e-5)
