"""``split_payloads`` and ``Net.inference_fn(weights_as_args=True)`` (the
port's ``sparse/weight_align.py`` and ``nn/net.py``) against the JAX
package's, on the CPU.

A narrow ResNet (tests/test_torch_net.py's ``_narrow_resnet``) is
initialised by the JAX package, carried over with ``params_from_jax``,
pruned to 75% in 16x16 blocks, fused and aligned on both sides, and run
with the default executor (the XBSP arms, ``use_xla_sparse=True``) and on
the kernel routes, f32: the forward over grafted payloads equals the
closed-over forward bit for bit, and JAX's
``inference_fn(weights_as_args=True)`` within rtol 1e-4, atol 1e-5 (sums
in another order). ``graft`` hands back the payload tensors themselves, and
a grafted ``BSC`` derives its XBSP casts and packings from the blocks it
was given: after the arms have filled the base object's ``memo``, new
blocks give the new blocks' answer."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.models import resnet as jresnet  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JLayerSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import \
    split_payloads as jsplit_payloads  # noqa: E402
from caffe_escoin_tpu.utils import pruning as jpruning  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs  # noqa: E402
from caffe_escoin_tpu_torch.models import resnet  # noqa: E402
from caffe_escoin_tpu_torch.nn import (LayerSpec, Net, fuse_inference,  # noqa: E402
                                       params_from_jax)
from caffe_escoin_tpu_torch.sparse.weight_align import (  # noqa: E402
    AlignedConvWeight, split_payloads, weight_align)
from caffe_escoin_tpu_torch.utils import pruning  # noqa: E402

from test_torch_net import BLOCK, SHAPES, TOL, _narrow_resnet, _prune  # noqa: E402

ROUTES = {"xbsp": True, "kernel": False}  # name -> use_xla_sparse


@pytest.fixture(scope="module")
def nets():
    """(JAX fused net, its aligned params, the port's fused net per route,
    its aligned params per route, the input)."""
    jpol = JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=BLOCK)
    jnet = JNet(_narrow_resnet(jresnet._conv_bn, jresnet._bottleneck,
                               JLayerSpec), policy=jpol, phase="test")
    jparams = jnet.init(jax.random.PRNGKey(0), SHAPES)
    np_params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                 for k, v in jparams.items()}
    params, state = params_from_jax(np_params, None)
    jpruned = _prune(jnet.specs, np_params, jpruning.prune_conv_weight,
                     jpruning.prune_blocks, jnp.asarray)
    jfnet, jfparams = jfuse(jnet, jpruned, state=jnet.state0)
    jaligned = jfnet.weight_align(jfparams)
    ports = {}
    for route, xla in ROUTES.items():
        net = Net(_narrow_resnet(resnet._conv_bn, resnet._bottleneck,
                                 LayerSpec),
                  policy=ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                                         block_shape=BLOCK,
                                         use_xla_sparse=xla))
        net.init(torch.Generator().manual_seed(0), SHAPES)
        pruned = _prune(net.specs, params, pruning.prune_conv_weight,
                        pruning.prune_blocks, torch.from_numpy)
        fnet, fparams = fuse_inference(net, pruned, state=net.state0)
        ports[route] = (fnet, fnet.weight_align(fparams))
    x = np.random.default_rng(1).standard_normal(SHAPES["data"]).astype(
        np.float32)
    return dict(jnet=jfnet, jaligned=jaligned, ports=ports, x=x)


def test_graft_hands_back_the_payload_tensors(nets):
    _, aligned = nets["ports"]["xbsp"]
    graft, payloads = split_payloads(aligned)
    assert set(payloads) == set(aligned)
    rebuilt = graft(payloads)
    n_sparse = 0
    for name, obj in aligned.items():
        got = rebuilt[name]
        if not isinstance(obj, AlignedConvWeight):
            assert got is payloads[name] is obj  # a plain dict rides whole
            continue
        pl = payloads[name]
        assert got.dense is pl["dense"] is obj.dense
        assert got.bias is pl.get("bias")
        if obj.bsc is not None:
            n_sparse += 1
            assert got.bsc.blocks is pl["bsc_blocks"]
            # the pattern stays on the base object
            assert got.bsc.block_row is obj.bsc.block_row
            assert got.bsc.bcol_nnz is obj.bsc.bcol_nnz
            assert got.bsc is not obj.bsc and got.bsc.memo == {}
        assert (got.kernel_shape, got.cin, got.cin_pad, got.cout) == (
            obj.kernel_shape, obj.cin, obj.cin_pad, obj.cout)
    assert n_sparse >= 10


def test_payload_keys_are_the_jax_keys_the_port_has(nets):
    """The JAX payload dicts' keys, less ``bsc_flat`` (the port's BSC has
    no flat copy of its blocks)."""
    jgraft, jpayloads = jsplit_payloads(nets["jaligned"])
    _, payloads = split_payloads(nets["ports"]["xbsp"][1])
    assert set(jpayloads) == set(payloads)
    for name, pl in payloads.items():
        if isinstance(pl, dict) and "dense" in pl:
            assert set(pl) == set(jpayloads[name]) - {"bsc_flat"}


@pytest.mark.parametrize("route", list(ROUTES))
def test_weights_as_args_is_the_closed_over_forward(nets, route):
    net, aligned = nets["ports"][route]
    x = {"data": torch.from_numpy(nets["x"])}
    closed = net.inference_fn(aligned, return_blobs=True)(x)
    as_args = net.inference_fn(aligned, return_blobs=True,
                               weights_as_args=True)(x)
    assert set(closed) == set(as_args)
    for blob in closed:
        assert torch.equal(closed[blob], as_args[blob]), blob


def test_weights_as_args_grafts_once_and_keeps_what_the_arms_derive(
        nets, monkeypatch):
    """The function grafts the payloads once, when it is made: its later
    calls run on the same grafted objects, whose memos the first call
    filled (a CUDA-graph capture after the first call must not build them:
    that would copy host to device inside the capture)."""
    from caffe_escoin_tpu_torch.sparse import weight_align as wa

    net, aligned = nets["ports"]["xbsp"]
    grafts, seen = [], []
    real = wa.split_payloads

    def counting(params):
        graft, payloads = real(params)

        def counted(pl):
            out = graft(pl)
            grafts.append(out)
            return out

        return counted, payloads

    monkeypatch.setattr("caffe_escoin_tpu_torch.nn.net.split_payloads",
                        counting)
    orig_forward = net.forward

    def spy(params, *a, **kw):
        seen.append(params)
        return orig_forward(params, *a, **kw)

    monkeypatch.setattr(net, "forward", spy)
    fwd = net.inference_fn(aligned, weights_as_args=True)
    x = {"data": torch.from_numpy(nets["x"])}
    first = fwd(x)["prob"]
    memos = {n: dict(p.bsc.memo) for n, p in grafts[0].items()
             if isinstance(p, AlignedConvWeight) and p.bsc is not None}
    assert any(memos.values())
    second = fwd(x)["prob"]
    assert len(grafts) == 1 and seen[0] is seen[1] is grafts[0]
    for n, memo in memos.items():
        got = grafts[0][n].bsc.memo
        assert all(got[k] is v for k, v in memo.items())
    assert torch.equal(first, second)


@pytest.fixture(scope="module")
def jax_as_args(nets):
    """JAX's forward over its grafted payloads, every blob (the jitted
    ``fwd(payloads, inputs)`` of its ``inference_fn(weights_as_args=
    True)``, with the blobs returned), and that function's own output."""
    jnet, jaligned = nets["jnet"], nets["jaligned"]
    graft, payloads = jsplit_payloads(jaligned)
    x = {"data": jnp.asarray(nets["x"])}
    blobs = jax.jit(lambda pl, i: jnet.apply(graft(pl), i,
                                             return_blobs=True))(payloads, x)
    out = jnet.inference_fn(jaligned, weights_as_args=True)(x)
    return {k: np.asarray(v) for k, v in blobs.items()}, np.asarray(
        out["prob"])


def test_jax_inference_fn_weights_as_args_is_its_grafted_forward(
        jax_as_args):
    blobs, prob = jax_as_args
    np.testing.assert_allclose(prob, blobs["prob"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("blob", ["fc", "prob"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_weights_as_args_matches_jax(nets, jax_as_args, route, blob):
    net, aligned = nets["ports"][route]
    out = net.inference_fn(aligned, weights_as_args=True,
                           return_blobs=True)(
        {"data": torch.from_numpy(nets["x"])})[blob].numpy()
    ref = jax_as_args[0][blob]
    assert out.shape == ref.shape == (2, 24) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)


XBSP_ARMS = {"unroll": xbs.conv, "gathered": xbs.conv_gathered,
             "gathered_cols": xbs.conv_gathered_cols}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arm", list(XBSP_ARMS))
def test_xbsp_arm_under_a_grafted_bsc_reads_the_new_blocks(arm, dtype):
    """The arm runs once on the base weight (filling its BSC's memo with
    the cast, union or per-column weights), then on a graft whose blocks
    are the base's times 2 (exact in bf16): it gives the answer of a
    weight aligned from 2 w, not the memo's."""
    rng = np.random.default_rng(3)
    w = pruning.prune_conv_weight(
        rng.standard_normal((3, 3, 32, 48)).astype(np.float32), 0.6,
        (16, 16))
    pol = ExecutionPolicy(block_shape=(16, 16))
    base = weight_align(w, rng.standard_normal(48).astype(np.float32),
                        policy=pol).to(dtype=dtype)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 32)).astype(
        np.float32)).to(dtype)
    fn = XBSP_ARMS[arm]
    before = fn(x, base, padding=(1, 1))
    assert base.bsc.memo  # the arm kept what it derived from the blocks
    graft, payloads = split_payloads({"c": base})
    payloads["c"] = dict(payloads["c"],
                         bsc_blocks=payloads["c"]["bsc_blocks"] * 2,
                         dense=payloads["c"]["dense"] * 2)
    grafted = graft(payloads)["c"]
    got = fn(x, grafted, padding=(1, 1))
    want = fn(x, weight_align(2 * w, base.bias.numpy(), policy=pol).to(
        dtype=dtype), padding=(1, 1))
    assert torch.equal(got, want)
    assert not torch.equal(got, before)
    # the base object's memo still serves the base weight
    assert torch.equal(fn(x, base, padding=(1, 1)), before)


def test_copying_the_memo_would_serve_the_old_blocks():
    """What the empty memo guards against: the unroll arm on bf16
    activations casts f32 blocks once and keeps the cast in the memo; a
    BSC whose memo is carried over (``dataclasses.replace`` leaves
    ``memo`` out, a copy would not) serves the old blocks' cast, the
    graft the new blocks'."""
    rng = np.random.default_rng(4)
    w = pruning.prune_conv_weight(
        rng.standard_normal((3, 3, 16, 16)).astype(np.float32), 0.5, (8, 8))
    base = weight_align(w, None, policy=ExecutionPolicy(block_shape=(8, 8)))
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 16)).astype(
        np.float32)).bfloat16()
    ref = xbs.conv(x, base, padding=(1, 1))
    assert ("blocks", torch.bfloat16) in base.bsc.memo
    stale = dataclasses.replace(base.bsc, blocks=base.bsc.blocks * 2)
    object.__setattr__(stale, "memo", dict(base.bsc.memo))
    stale_out = xbs.conv(x, dataclasses.replace(base, bsc=stale),
                         padding=(1, 1))
    graft, payloads = split_payloads({"c": base})
    payloads["c"]["bsc_blocks"] = base.bsc.blocks * 2
    fresh_out = xbs.conv(x, graft(payloads)["c"], padding=(1, 1))
    assert torch.equal(stale_out, ref)  # the copied memo's old answer
    want = xbs.conv(x, weight_align(2 * w, None, policy=ExecutionPolicy(
        block_shape=(8, 8))), padding=(1, 1))
    assert torch.equal(fresh_out, want) and not torch.equal(fresh_out, ref)
