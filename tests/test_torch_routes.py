"""Route parity at full shape: for every conv of VGG-16 at b16, ResNet-50
at b32, GoogLeNet at b32 (224x224) and AlexNet at b32 (227x227, grouped
conv2, conv4 and conv5), weights pruned to 90% in 128x128 blocks where a
group has 32 or more input channels (the 3-channel stems stay dense), in
bf16 and f32, the port's ``conv_route`` (through ``Net.routes``) names the
kernel that the JAX dispatcher calls with ``use_xla_sparse=False``.

The JAX side runs its real ``conv2d`` under ``jax.eval_shape`` on a
``jax.ShapeDtypeStruct``, so its size gates see the full shapes and nothing
is computed; spies on its kernel entries record which one it reached.

The same at VGG-16 b16 and ResNet-50 b32 on the XBSP branch with the fused
arm forced: the reference's size gate decides where the fused kernel runs.

The same on the packed nets (``pack_narrow_chains`` after fusion, as
bench.py runs them; GoogLeNet's stem folded by space-to-depth first, as
bench.py folds it), in bf16, on the kernel routes and on the XBSP branch:
every conv of packed ResNet-50 b32, VGG-16 b16 and GoogLeNet b32 at its
packed shapes, the JAX side through its real layer ``apply`` (which runs
the packed and the s2d geometry) under ``jax.eval_shape``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import bsc_pallas as jbsc_pallas  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_fused as jsconv_fused  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_pallas as jsconv_pallas  # noqa: E402
from caffe_escoin_tpu.kernels import xla_block_sparse as jxbs  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fold_stem_s2d as jfold  # noqa: E402
from caffe_escoin_tpu.nn.fuse import pack_narrow_chains as jpack  # noqa: E402
from caffe_escoin_tpu.ops import conv as jconv  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net  # noqa: E402
from caffe_escoin_tpu_torch.nn.fuse import (fold_stem_s2d,  # noqa: E402
                                            pack_narrow_chains)
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight  # noqa: E402
from test_torch_pack_pass import _zoo_fused  # noqa: E402

BLOCK = (128, 128)
SPARSITY = 0.9
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}
JPOL = JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=BLOCK,
               use_pallas=True, use_xla_sparse=False)


def _policy(dtype):
    return ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                           compute_dtype=dtype, cast_back=False,
                           use_xla_sparse=False)


@pytest.fixture(scope="module",
                params=["vgg16", "resnet50", "googlenet", "alexnet"])
def model(request):
    """Per conv layer: its spec, input shape and the weight aligned on both
    sides (the fc layers are left out: their route is not gated by size).
    A grouped conv's weight is [k, k, cin/group, cout], pruned as
    chip_smoke.py prunes it (when cin/group >= 32)."""
    build, shapes = ZOO[request.param]
    net = Net(build(), policy=_policy(None))
    rng = np.random.default_rng(0)
    convs = {}
    for layer, in_shapes in net.walk_shapes(shapes):
        spec = layer.spec
        if spec.type not in ("Convolution", "ConvolutionReLU"):
            continue
        k, g = spec.params["kernel"], spec.params.get("group", 1)
        cin, cout = in_shapes[0][-1], spec.params["num_output"]
        w = rng.standard_normal((k, k, cin // g, cout)).astype(np.float32)
        if cin // g >= 32:
            w = prune_conv_weight(w, SPARSITY, BLOCK)
        convs[spec.name] = dict(
            spec=spec, x=in_shapes[0],
            aligned=weight_align(w, groups=g, policy=_policy(None)),
            jaligned=jweight_align(w, groups=g, policy=JPOL,
                                   with_stats=False))
    return request.param, shapes, convs


def _jax_route(monkeypatch, conv, jdtype):
    """The kernel entry the JAX dispatcher reaches for this layer."""
    seen = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen.append(name)
            return fn(*a, **kw)
        return wrapped

    for mod, attr, name in ((jconv, "conv2d_dense", "dense"),
                            (jconv, "conv2d_lowered_sparse", "lowered"),
                            (jsconv_fused, "sconv", "fused"),
                            (jsconv_pallas, "sconv", "gc"),
                            (jbsc_pallas, "bsc_spmm_pallas", "spmm_1x1")):
        monkeypatch.setattr(mod, attr, spy(name, getattr(mod, attr)))
    p = conv["spec"].params
    stride, pad = p.get("stride", 1), p.get("pad", 0)
    jax.eval_shape(
        lambda x: jconv.conv2d(x, conv["jaligned"], stride=(stride, stride),
                               padding=(pad, pad), policy=JPOL),
        jax.ShapeDtypeStruct(conv["x"], jdtype))
    monkeypatch.undo()
    return seen[0]  # the outermost entry (lowered runs the SpMM inside)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_routes_match_jax_dispatch(model, dtype, monkeypatch):
    name, shapes, convs = model
    tdtype, jdtype = DTYPES[dtype]
    net = Net(ZOO[name][0](), policy=_policy(tdtype))
    routes = net.routes({k: c["aligned"] for k, c in convs.items()}, shapes)
    ported = {k: routes[k] for k in convs}
    jax_routes = {k: _jax_route(monkeypatch, c, jdtype)
                  for k, c in convs.items()}
    assert ported == jax_routes
    if name == "vgg16" and dtype == "bf16":
        expect = dict.fromkeys(convs, "fused")
        expect.update(conv1_1="dense", conv1_2="lowered", conv2_1="gc",
                      conv2_2="gc", conv3_2="gc", conv3_3="gc")
        assert ported == expect
    if name == "resnet50" and dtype == "bf16":
        # every sparse conv takes the fused kernel, the stride-2 1x1 ones
        # after subsampling; the stem and res2a_branch2a (one 64x64 block,
        # which block pruning keeps) stay dense
        expect = {k: "fused" if c["aligned"].sparsity >= 0.5 else "dense"
                  for k, c in convs.items()}
        assert sorted(k for k, r in expect.items() if r == "dense") == [
            "conv1", "res2a_branch2a"]
        assert ported == expect
    if name == "googlenet" and dtype == "bf16":
        # the stem, conv2/3x3_reduce and five convs of inception_3a (whose
        # pruning keeps one of their two blocks), and the 5x5s of 4a-4c
        # (16 or 24 input channels, unpruned) run dense; the other 47 the
        # fused kernel
        dense = sorted(k for k, r in ported.items() if r == "dense")
        assert dense == sorted(
            ["conv1/7x7_s2", "conv2/3x3_reduce", "inception_4a/5x5",
             "inception_4b/5x5", "inception_4c/5x5"]
            + [f"inception_3a/{b}" for b in ("1x1", "3x3_reduce",
                                             "5x5_reduce", "5x5",
                                             "pool_proj")])
        assert sum(r == "fused" for r in ported.values()) == 47
    if name == "alexnet" and dtype == "bf16":
        # the grouped conv2, conv4 and conv5 take the fused kernel on their
        # block-diagonal weights
        assert ported == dict(conv1="dense", conv2="fused", conv3="fused",
                              conv4="fused", conv5="fused")


XBSP_SPIES = ((jconv, "conv2d_dense", "dense"),
              (jxbs, "conv", "unroll"),
              (jsconv_fused, "sconv", "fused"))


def test_forced_fused_arm_keeps_the_reference_size_gate(model, monkeypatch):
    """The XBSP branch with ``xbsp_arm="fused"`` in bf16: the JAX dispatcher
    (Pallas on) runs its fused kernel only where ``sconv_fused.supported``
    holds, size budget included, and the unroll elsewhere; the port's
    routes follow it. On VGG-16 b16 five convs miss the budget; every conv
    of ResNet-50, GoogLeNet and AlexNet at b32 fits."""
    name, shapes, convs = model
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                          compute_dtype=torch.bfloat16, cast_back=False,
                          xbsp_arm="fused")
    jpol = JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=BLOCK,
                   use_pallas=True, xbsp_arm="fused")
    net = Net(ZOO[name][0](), policy=pol)
    routes = net.routes({k: c["aligned"] for k, c in convs.items()}, shapes)
    ported = {k: routes[k] for k in convs}
    seen = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen.append(name)
            return fn(*a, **kw)
        return wrapped

    jax_routes = {}
    for k, c in convs.items():
        p = c["spec"].params
        stride, pad = p.get("stride", 1), p.get("pad", 0)
        seen.clear()
        for mod, attr, arm in XBSP_SPIES:
            monkeypatch.setattr(mod, attr, spy(arm, getattr(mod, attr)))
        jax.eval_shape(
            lambda x: jconv.conv2d(x, c["jaligned"], stride=(stride, stride),
                                   padding=(pad, pad), policy=jpol),
            jax.ShapeDtypeStruct(c["x"], jnp.bfloat16))
        monkeypatch.undo()
        jax_routes[k] = seen[0]
    assert ported == jax_routes
    if name == "vgg16":
        assert sorted(k for k, r in ported.items() if r == "unroll") == [
            "conv1_2", "conv2_1", "conv2_2", "conv3_2", "conv3_3"]
        assert sum(r == "fused" for r in ported.values()) == 7
    else:  # every conv of ResNet-50, GoogLeNet and AlexNet at b32 fits
        assert "unroll" not in ported.values()


PACKED_BATCH = {"vgg16": 16, "resnet50": 32, "googlenet": 32}
PACKED_SPIES = {
    False: ((jconv, "conv2d_dense", "dense"),
            (jconv, "conv2d_lowered_sparse", "lowered"),
            (jsconv_fused, "sconv", "fused"),
            (jsconv_pallas, "sconv", "gc"),
            (jbsc_pallas, "bsc_spmm_pallas", "spmm_1x1")),
    True: ((jconv, "conv2d_dense", "dense"),
           (jxbs, "conv", "unroll"),
           (jxbs, "conv_gathered", "gathered"),
           (jxbs, "conv_gathered_cols", "gathered_cols"),
           (jsconv_fused, "sconv", "fused")),
}


@pytest.fixture(scope="module", params=["vgg16", "resnet50", "googlenet"])
def packed_model(request):
    """The packed, fused net on both sides (weights pruned to 90% in
    128x128 blocks, the stem dense; GoogLeNet's stem folded by
    space-to-depth before packing, as bench.py does), every conv aligned by
    its own layer (the packed weight), and each conv's packed input
    shapes."""
    name = request.param
    shapes, (fparams, jfparams), fnet, jfnet = _zoo_fused(
        name, PACKED_BATCH[name], BLOCK)
    if name == "googlenet":
        fnet, fparams = fold_stem_s2d(fnet, fparams)
        jfnet, jfparams = jfold(jfnet, jfparams)
        assert fnet.specs[0].params["s2d_r"] == 2
    pnet, jpnet = pack_narrow_chains(fnet), jpack(jfnet)
    pol, jpol = _policy(None), JPOL
    pnet = Net(pnet.specs, policy=pol)
    jlayers = {lay.spec.name: lay
               for lay in JNet(jpnet.specs, policy=jpol, phase="test").layers}
    convs = {}
    for layer, in_shapes in pnet.walk_shapes(shapes):
        name_ = layer.spec.name
        if layer.spec.type not in ("Convolution", "ConvolutionReLU"):
            continue
        convs[name_] = dict(
            xs=in_shapes, spec=layer.spec,
            aligned=layer.align(fparams[name_]),
            jaligned=jlayers[name_].align(jfparams[name_]))
    return name, shapes, pnet.specs, jpnet.specs, convs


@pytest.mark.parametrize("use_xla_sparse", [False, True])
def test_packed_routes_match_jax_dispatch(packed_model, use_xla_sparse,
                                          monkeypatch):
    name, shapes, specs, jspecs, convs = packed_model
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                          compute_dtype=torch.bfloat16, cast_back=False,
                          use_xla_sparse=use_xla_sparse)
    jpol = JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=BLOCK,
                   use_pallas=True, compute_dtype=jnp.bfloat16,
                   cast_back=False, use_xla_sparse=use_xla_sparse)
    routes = Net(specs, policy=pol).routes(
        {k: c["aligned"] for k, c in convs.items()}, shapes)
    ported = {k: routes[k] for k in convs}
    jlayers = {lay.spec.name: lay
               for lay in JNet(jspecs, policy=jpol, phase="test").layers}
    seen = []

    def spy(arm, fn):
        def wrapped(*a, **kw):
            seen.append(arm)
            return fn(*a, **kw)
        return wrapped

    jax_routes = {}
    for k, c in convs.items():
        seen.clear()
        for mod, attr, arm in PACKED_SPIES[use_xla_sparse]:
            monkeypatch.setattr(mod, attr, spy(arm, getattr(mod, attr)))
        jax.eval_shape(  # a fused residual is the second input
            lambda *ys, k=k, c=c: jlayers[k].apply(c["jaligned"], list(ys),
                                                   train=False, rng=None),
            *[jax.ShapeDtypeStruct(x, jnp.bfloat16) for x in c["xs"]])
        monkeypatch.undo()
        jax_routes[k] = seen[0]
    assert ported == jax_routes
    if use_xla_sparse:
        return
    if name == "resnet50":
        # packing makes res2a_branch2a's block-diagonal weight 50% sparse:
        # 52 fused convs, the stem dense
        assert ported["res2a_branch2a"] == "fused"
        assert [k for k, r in ported.items() if r != "fused"] == ["conv1"]
        assert ported["conv1"] == "dense"
    elif name == "googlenet":
        # likewise conv2/3x3_reduce (64 -> 64 at r = 2): 48 fused, and the
        # folded stem dense on its 12-channel s2d grid
        assert ported["conv2/3x3_reduce"] == "fused"
        assert ported["conv1/7x7_s2"] == "dense"
        assert sum(r == "fused" for r in ported.values()) == 48
        assert sum(r == "dense" for r in ported.values()) == 9
    else:
        expect = dict.fromkeys(convs, "fused")
        expect.update(conv1_1="dense", conv1_2="lowered", conv2_1="gc",
                      conv2_2="gc", conv3_2="gc", conv3_3="gc")
        assert ported == expect
