"""The XBSP branch of the dispatch (``use_xla_sparse=True``, the default)
against the JAX package's.

* Routes at full shape: for every conv and fc of VGG-16 b16 and ResNet-50
  b32 (weights pruned to 90% in 128x128 blocks, the 3-channel stem dense),
  in bf16 and f32, with autotune off, the port's ``Net.routes`` names the
  arm that the JAX dispatcher runs. The JAX side runs its real ``conv2d``
  and InnerProduct layer under ``jax.eval_shape`` (nothing is computed);
  spies on its arm functions record which one it reached.
* The slice: the narrow ResNet of test_torch_net.py, pruned to 90% in 8x8
  blocks (so the arms "unroll", "gathered" and "dense" all occur), under
  the default policy in SCONV_PAR and SCONV, forced arms, and
  LOWERED_SPARSE, against JAX ``Net.apply`` blob by blob in f32 (rtol
  1e-4, atol 1e-5: sums in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_fused as jsconv_fused  # noqa: E402
from caffe_escoin_tpu.kernels import xla_block_sparse as jxbs  # noqa: E402
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.models import resnet as jresnet  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JLayerSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.ops import conv as jconv  # noqa: E402
from caffe_escoin_tpu.ops import linear as jlinear  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402
from caffe_escoin_tpu.utils import pruning as jpruning  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_fused  # noqa: E402
from caffe_escoin_tpu_torch.models import ZOO, resnet  # noqa: E402
from caffe_escoin_tpu_torch.nn import (LayerSpec, Net, fuse_inference,  # noqa: E402
                                       params_from_jax)
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils import pruning  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,  # noqa: E402
                                                  prune_conv_weight)
from test_torch_net import SHAPES, TOL, _narrow_resnet  # noqa: E402

BLOCK = (128, 128)
SPARSITY = 0.9
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}
JPOL = JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=BLOCK)


def _policy(dtype):
    return ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                           compute_dtype=dtype, cast_back=False)


@pytest.fixture(scope="module", params=["vgg16", "resnet50"])
def model(request):
    """Per conv and fc layer: its spec, input shape, and the weight aligned
    on both sides."""
    build, shapes = ZOO[request.param]
    net = Net(build(), policy=_policy(None))
    rng = np.random.default_rng(0)
    layers = {}
    for layer, in_shapes in net.walk_shapes(shapes):
        spec = layer.spec
        if spec.type in ("Convolution", "ConvolutionReLU"):
            k = spec.params["kernel"]
            cin, cout = in_shapes[0][-1], spec.params["num_output"]
            w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
            if cin >= 32:
                w = prune_conv_weight(w, SPARSITY, BLOCK)
        elif spec.type == "InnerProduct":
            kdim = int(np.prod(in_shapes[0][1:]))
            w = prune_blocks(rng.standard_normal(
                (kdim, spec.params["num_output"])).astype(np.float32),
                SPARSITY, BLOCK)[None, None]
        else:
            continue
        layers[spec.name] = dict(
            spec=spec, x=in_shapes[0],
            aligned=weight_align(w, policy=_policy(None)),
            jaligned=jweight_align(w, policy=JPOL, with_stats=False))
    return request.param, shapes, layers


def _spied(monkeypatch, spies, run):
    """The first spied entry that ``run`` reaches."""
    seen = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen.append(name)
            return fn(*a, **kw)
        return wrapped

    for mod, attr, name in spies:
        monkeypatch.setattr(mod, attr, spy(name, getattr(mod, attr)))
    try:
        run()
    finally:
        monkeypatch.undo()
    return seen[0]


CONV_SPIES = ((jconv, "conv2d_dense", "dense"),
              (jxbs, "conv", "unroll"),
              (jxbs, "conv_gathered", "gathered"),
              (jxbs, "conv_gathered_cols", "gathered_cols"),
              (jsconv_fused, "sconv", "fused"))
FC_SPIES = ((jxbs, "spmm", "xbsp_spmm"), (jlinear, "linear", "dense"))


def _jax_route(monkeypatch, name, layer, jdtype):
    spec, x = layer["spec"], jax.ShapeDtypeStruct(layer["x"], jdtype)
    if spec.type == "InnerProduct":
        jlayer = next(lay for lay in JNet(JZOO[name][0](), policy=JPOL).layers
                      if lay.spec.name == spec.name)
        return _spied(monkeypatch, FC_SPIES, lambda: jax.eval_shape(
            lambda y: jlayer.apply(layer["jaligned"], [y], train=False,
                                   rng=None), x))
    p = spec.params
    stride, pad = p.get("stride", 1), p.get("pad", 0)
    return _spied(monkeypatch, CONV_SPIES, lambda: jax.eval_shape(
        lambda y: jconv.conv2d(y, layer["jaligned"], stride=(stride, stride),
                               padding=(pad, pad), policy=JPOL), x))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_routes_match_jax_xbsp_dispatch(model, dtype, monkeypatch):
    name, shapes, layers = model
    tdtype, jdtype = DTYPES[dtype]
    net = Net(ZOO[name][0](), policy=_policy(tdtype))
    routes = net.routes({k: v["aligned"] for k, v in layers.items()}, shapes)
    jax_routes = {k: _jax_route(monkeypatch, name, v, jdtype)
                  for k, v in layers.items()}
    assert routes == jax_routes
    counts = {r: sum(v == r for v in routes.values())
              for r in set(routes.values())}
    if name == "resnet50":
        # the 3x3 and reduce 1x1 convs unroll, the expand 1x1 convs gather,
        # the stem, res2a_branch2a (one live block) and the stride-2 3x3
        # convs run dense
        assert counts["unroll"] > 0 and counts["gathered"] > 0
        assert routes["conv1"] == routes["res2a_branch2a"] == "dense"
        assert routes["fc1000"] == "xbsp_spmm"
    else:
        assert routes["conv1_1"] == "dense" and routes["conv1_2"] == "unroll"
        assert {routes[f] for f in ("fc6", "fc7", "fc8")} == {"xbsp_spmm"}


# -- the slice: narrow ResNet, 8x8 blocks, 90% -------------------------------

SLICE_BLOCK = (8, 8)
# (mode, forced arm)
SLICE_CASES = {
    "sconv_par_auto": (ConvMode.SCONV_PAR, "auto"),
    "sconv_auto": (ConvMode.SCONV, "auto"),
    "sconv_par_gathered_cols": (ConvMode.SCONV_PAR, "gathered_cols"),
    "sconv_gathered": (ConvMode.SCONV, "gathered"),
    "lowered_sparse": (ConvMode.LOWERED_SPARSE, "auto"),
}


def _prune_slice(specs, params, prune_conv, prune_fc, asarray):
    out = dict(params)
    for s in specs:
        if s.name not in out or s.type not in ("Convolution", "InnerProduct"):
            continue
        q = dict(out[s.name])
        w = np.asarray(q["w"])
        if s.type == "Convolution":
            if w.shape[2] < 8:
                continue
            q["w"] = asarray(prune_conv(w, SPARSITY, SLICE_BLOCK))
        else:
            q["w"] = asarray(prune_fc(w, SPARSITY, SLICE_BLOCK))
        out[s.name] = q
    return out


@pytest.fixture(scope="module")
def slice_params():
    """JAX-initialised params and BatchNorm statistics, carried over."""
    jnet = JNet(_narrow_resnet(jresnet._conv_bn, jresnet._bottleneck,
                               JLayerSpec), policy=JPolicy(), phase="test")
    jparams = jnet.init(jax.random.PRNGKey(0), SHAPES)
    rng = np.random.default_rng(0)
    jstate = {}
    for name, st in jnet.state0.items():
        c = st["mean_acc"].shape[0]
        jstate[name] = {
            "mean_acc": rng.standard_normal(c).astype(np.float32) * 0.2,
            "var_acc": rng.uniform(1.0, 3.0, c).astype(np.float32),
            "count": np.float32(2.0)}
    np_params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                 for k, v in jparams.items()}
    x = np.random.default_rng(1).standard_normal(SHAPES["data"]).astype(
        np.float32)
    return np_params, jstate, x


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_slice_matches_jax_apply_blob_by_blob(slice_params, case):
    mode, arm = SLICE_CASES[case]
    np_params, jstate, x = slice_params
    jpol = JPolicy(conv_mode=JConvMode(int(mode)), block_shape=SLICE_BLOCK,
                   xbsp_arm=arm)
    pol = ExecutionPolicy(conv_mode=mode, block_shape=SLICE_BLOCK,
                          xbsp_arm=arm)
    jnet = JNet(_narrow_resnet(jresnet._conv_bn, jresnet._bottleneck,
                               JLayerSpec), policy=jpol, phase="test")
    net = Net(_narrow_resnet(resnet._conv_bn, resnet._bottleneck, LayerSpec),
              policy=pol)
    params, state = params_from_jax(np_params, jstate)
    jfnet, jfparams = jfuse(jnet, _prune_slice(
        jnet.specs, np_params, jpruning.prune_conv_weight,
        jpruning.prune_blocks, jnp.asarray), state=jstate)
    fnet, fparams = fuse_inference(net, _prune_slice(
        net.specs, params, pruning.prune_conv_weight, pruning.prune_blocks,
        torch.from_numpy), state=state)
    jblobs = jfnet.apply(jfnet.weight_align(jfparams),
                         {"data": jnp.asarray(x)}, return_blobs=True)
    aligned = fnet.weight_align(fparams)
    routes = fnet.routes(aligned, SHAPES)
    calls = (sconv_fused.calls, bsc_spmm.calls)
    blobs = fnet.apply(aligned, {"data": torch.from_numpy(x)},
                       return_blobs=True)
    # the XBSP branch calls no kernel entry
    assert (sconv_fused.calls, bsc_spmm.calls) == calls
    assert set(blobs) == set(jblobs)
    for name, blob in blobs.items():
        np.testing.assert_allclose(blob.numpy(), np.asarray(jblobs[name]),
                                   err_msg=name, **TOL)
    used = set(routes.values())
    assert routes["fc"] == "xbsp_spmm"
    if mode == ConvMode.LOWERED_SPARSE:
        assert used == {"dense", "xbsp_lowered", "xbsp_spmm"}
    elif arm == "auto":
        assert {"unroll", "gathered", "dense"} <= used
    else:
        assert arm in used
