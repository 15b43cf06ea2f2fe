"""Route parity at full shape: for every conv of VGG-16 at b16 and ResNet-50
at b32 (224x224, weights pruned to 90% in 128x128 blocks, the 3-channel
stem dense), in bf16 and f32, the port's ``conv_route`` (through
``Net.routes``) names the kernel that the JAX dispatcher calls with
``use_xla_sparse=False``.

The JAX side runs its real ``conv2d`` under ``jax.eval_shape`` on a
``jax.ShapeDtypeStruct``, so its size gates see the full shapes and nothing
is computed; spies on its kernel entries record which one it reached.

The same at VGG-16 b16 and ResNet-50 b32 on the XBSP branch with the fused
arm forced: the reference's size gate decides where the fused kernel runs.
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
from caffe_escoin_tpu.ops import conv as jconv  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net  # noqa: E402
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight  # noqa: E402

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


@pytest.fixture(scope="module", params=["vgg16", "resnet50"])
def model(request):
    """Per conv layer: its spec, input shape and the weight aligned on both
    sides (the fc layers are left out: their route is not gated by size)."""
    build, shapes = ZOO[request.param]
    net = Net(build(), policy=_policy(None))
    rng = np.random.default_rng(0)
    convs = {}
    for layer, in_shapes in net.walk_shapes(shapes):
        spec = layer.spec
        if spec.type not in ("Convolution", "ConvolutionReLU"):
            continue
        k = spec.params["kernel"]
        cin, cout = in_shapes[0][-1], spec.params["num_output"]
        w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
        if cin >= 32:
            w = prune_conv_weight(w, SPARSITY, BLOCK)
        convs[spec.name] = dict(
            spec=spec, x=in_shapes[0],
            aligned=weight_align(w, policy=_policy(None)),
            jaligned=jweight_align(w, policy=JPOL, with_stats=False))
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


XBSP_SPIES = ((jconv, "conv2d_dense", "dense"),
              (jxbs, "conv", "unroll"),
              (jsconv_fused, "sconv", "fused"))


def test_forced_fused_arm_keeps_the_reference_size_gate(model, monkeypatch):
    """The XBSP branch with ``xbsp_arm="fused"`` in bf16: the JAX dispatcher
    (Pallas on) runs its fused kernel only where ``sconv_fused.supported``
    holds, size budget included, and the unroll elsewhere; the port's
    routes follow it. On VGG-16 b16 five convs miss the budget; every conv
    of ResNet-50 b32 fits."""
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
    else:
        assert "unroll" not in ported.values()
