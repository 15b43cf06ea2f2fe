"""The unstructured-sparsity path whole: LOWERED_SPARSE with the ELL format
(``sparse_format=ELL``), the JAX package's path for element-wise pruned
weights, against the JAX package's.

* The slice: the narrow ResNet of test_torch_net.py, its conv weights
  (not the 3-channel stem) and fc weight pruned element-wise to 90%, fused
  and aligned on both sides, run whole against JAX ``Net.apply`` under the
  same policy, blob by blob in f32: rtol 1e-4, atol 1e-5 (sums in another
  order), as test_torch_net.py. Its routes against the JAX dispatcher.
* ResNet-50 at b32 (224x224), pruned the same way, in bf16: the port's
  ``Net.routes`` names the executor the JAX dispatcher reaches for every
  conv and the fc: conv1 dense, the other 52 convs "ell", and fc1000
  dense, since element-wise pruning leaves every 128x128 block live.
  The JAX side runs its real ``conv2d`` and InnerProduct layer under
  ``jax.eval_shape`` (nothing is computed); spies on its executors record
  which one it reached.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.engine.context import SparseFormat as JSparseFormat  # noqa: E402
from caffe_escoin_tpu.kernels import spmm as jspmm  # noqa: E402
from caffe_escoin_tpu.kernels import xla_block_sparse as jxbs  # noqa: E402
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.models import resnet as jresnet  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JLayerSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.ops import conv as jconv  # noqa: E402
from caffe_escoin_tpu.ops import linear as jlinear  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import (ConvMode,  # noqa: E402
                                                   ExecutionPolicy,
                                                   SparseFormat)
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_fused  # noqa: E402
from caffe_escoin_tpu_torch.models import ZOO, resnet  # noqa: E402
from caffe_escoin_tpu_torch.nn import (LayerSpec, Net, fuse_inference,  # noqa: E402
                                       params_from_jax)
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import (prune_conv_weight,  # noqa: E402
                                                  prune_magnitude)
from test_torch_net import SHAPES, TOL, _narrow_resnet  # noqa: E402

SPARSITY = 0.9
SLICE_BLOCK = (8, 8)
CONV_SPIES = ((jconv, "conv2d_dense", "dense"),
              (jspmm, "ell_spmm", "ell"),
              (jxbs, "spmm", "xbsp_lowered"))
FC_SPIES = ((jxbs, "spmm", "xbsp_spmm"), (jlinear, "linear", "dense"))


def _jpol(block, dtype=None):
    return JPolicy(conv_mode=JConvMode.LOWERED_SPARSE, block_shape=block,
                   sparse_format=JSparseFormat.ELL, compute_dtype=dtype,
                   cast_back=dtype is None)


def _pol(block, dtype=None):
    return ExecutionPolicy(conv_mode=ConvMode.LOWERED_SPARSE,
                           block_shape=block, sparse_format=SparseFormat.ELL,
                           compute_dtype=dtype, cast_back=dtype is None)


def _prune(w, is_fc):
    """bench.py's --granularity unstructured: element-wise magnitude
    pruning; the 3-channel stem stays dense (None)."""
    if is_fc:
        return prune_magnitude(w, SPARSITY)
    if w.shape[2] < 8:
        return None
    return prune_conv_weight(w, SPARSITY, None)


def _spied(monkeypatch, spies, run):
    """The first spied executor that ``run`` reaches."""
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


def _jax_route(monkeypatch, jlayer, jaligned, x_shape, jdtype):
    x = jax.ShapeDtypeStruct(x_shape, jdtype)
    spec = jlayer.spec
    if spec.type == "InnerProduct":
        return _spied(monkeypatch, FC_SPIES, lambda: jax.eval_shape(
            lambda y: jlayer.apply(jaligned, [y], train=False, rng=None), x))
    p = spec.params
    stride, pad = p.get("stride", 1), p.get("pad", 0)
    return _spied(monkeypatch, CONV_SPIES, lambda: jax.eval_shape(
        lambda y: jconv.conv2d(y, jaligned, stride=(stride, stride),
                               padding=(pad, pad), policy=jlayer.policy), x))


# -- the slice: narrow ResNet, element-wise 90% --------------------------------

@pytest.fixture(scope="module")
def slice_run():
    jnet = JNet(_narrow_resnet(jresnet._conv_bn, jresnet._bottleneck,
                               JLayerSpec), policy=_jpol(SLICE_BLOCK),
                phase="test")
    net = Net(_narrow_resnet(resnet._conv_bn, resnet._bottleneck, LayerSpec),
              policy=_pol(SLICE_BLOCK))
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
    for s in jnet.specs:
        if s.type in ("Convolution", "InnerProduct"):
            wp = _prune(np_params[s.name]["w"], s.type == "InnerProduct")
            if wp is not None:
                np_params[s.name]["w"] = wp
    params, state = params_from_jax(np_params, jstate)
    jfnet, jfparams = jfuse(jnet, {k: {kk: jnp.asarray(vv) for kk, vv in
                                       v.items()}
                                   for k, v in np_params.items()},
                            state=jstate)
    fnet, fparams = fuse_inference(net, params, state=state)
    x = np.random.default_rng(1).standard_normal(SHAPES["data"]).astype(
        np.float32)
    jaligned = jfnet.weight_align(jfparams)
    jblobs = jfnet.apply(jaligned, {"data": jnp.asarray(x)},
                         return_blobs=True)
    aligned = fnet.weight_align(fparams)
    calls = (sconv_fused.calls, bsc_spmm.calls)
    blobs = fnet.apply(aligned, {"data": torch.from_numpy(x)},
                       return_blobs=True)
    moved = (sconv_fused.calls - calls[0], bsc_spmm.calls - calls[1])
    return dict(jfnet=jfnet, fnet=fnet, jaligned=jaligned, aligned=aligned,
                jblobs=jblobs, blobs=blobs, moved=moved)


def test_slice_matches_jax_apply_blob_by_blob(slice_run):
    blobs, jblobs = slice_run["blobs"], slice_run["jblobs"]
    assert set(blobs) == set(jblobs)
    for name, blob in blobs.items():
        assert np.isfinite(blob.numpy()).all(), name
        np.testing.assert_allclose(blob.numpy(), np.asarray(jblobs[name]),
                                   err_msg=name, **TOL)
    assert slice_run["moved"] == (0, 0)  # the ELL path calls no kernel entry


def test_slice_routes_match_jax_dispatch(slice_run, monkeypatch):
    fnet, aligned = slice_run["fnet"], slice_run["aligned"]
    routes = fnet.routes(aligned, SHAPES)
    jlayers = {lay.spec.name: lay for lay in slice_run["jfnet"].layers}
    jax_routes = {
        layer.spec.name: _jax_route(
            monkeypatch, jlayers[layer.spec.name],
            slice_run["jaligned"][layer.spec.name], in_shapes[0],
            jnp.float32)
        for layer, in_shapes in fnet.walk_shapes(SHAPES)
        if layer.spec.name in routes}
    assert routes == jax_routes
    sparse_convs = [n for n, r in routes.items() if r == "ell"]
    assert routes["conv1"] == "dense" and routes["fc"] == "dense"
    assert len(sparse_convs) == len(routes) - 2 == 14
    for name in sparse_convs:
        ell = aligned[name].ell_t
        assert ell.shape == (aligned[name].cout, aligned[name].k)
        assert ell.width % 8 == 0 and ell.nnz == aligned[name].stats.nnz


# -- ResNet-50 b32 at full shape: the routes ---------------------------------

def test_resnet50_b32_routes_match_jax_dispatch(monkeypatch):
    build, shapes = ZOO["resnet50"]
    pol, jpol = _pol((128, 128), torch.bfloat16), _jpol((128, 128),
                                                        jnp.bfloat16)
    net = Net(build(), policy=pol)
    jlayers = {lay.spec.name: lay
               for lay in JNet(JZOO["resnet50"][0](), policy=jpol).layers}
    rng = np.random.default_rng(0)
    aligned, jax_routes = {}, {}
    for layer, in_shapes in net.walk_shapes(shapes):
        spec = layer.spec
        if spec.type == "InnerProduct":
            w = rng.standard_normal((int(np.prod(in_shapes[0][1:])),
                                     spec.params["num_output"]))
            w = prune_magnitude(w.astype(np.float32), SPARSITY)[None, None]
        elif spec.type in ("Convolution", "ConvolutionReLU"):
            k = spec.params["kernel"]
            w = rng.standard_normal((k, k, in_shapes[0][-1],
                                     spec.params["num_output"])).astype(
                np.float32)
            w = _prune(w, False) if w.shape[2] >= 8 else w
        else:
            continue
        aligned[spec.name] = weight_align(w, policy=pol)
        jax_routes[spec.name] = _jax_route(
            monkeypatch, jlayers[spec.name],
            jweight_align(w, policy=jpol, with_stats=False), in_shapes[0],
            jnp.bfloat16)
    assert shapes["data"] == (32, 224, 224, 3)
    routes = net.routes(aligned, shapes)
    assert routes == jax_routes
    assert routes["conv1"] == "dense" and routes["fc1000"] == "dense"
    assert sorted(set(routes.values())) == ["dense", "ell"]
    assert sum(r == "ell" for r in routes.values()) == 52
    assert aligned["fc1000"].block_density > 0.5
