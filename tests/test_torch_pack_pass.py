"""The port's W-pair packed-layout pass (``nn/fuse.pack_narrow_chains``), its
packed pooling (``ops/pool.pool2d_packed``, ``pool2d_packed_out``) and the
layers' packed execution, against the JAX package's.

* Structure: on the same specs and blob shapes both passes mark the same
  blobs at the same factors and give every layer the same
  ``pack_in``/``pack_out``/``pack_w``: the bottleneck tower of
  tests/test_pack_pass.py and a pooled chain at ``lanes=8``, a narrow
  ResNet at ``lanes=32``, fused ResNet-50 (12 blobs) and VGG-16 (5) at
  batch 1, and nets whose narrow blobs feed a global pool or are final
  tops (refused).
* Packing is exact: in the port, packed == unpacked on the dense path, the
  aligned default executor (XBSP arms, ``block_shape=(4, 4)``) and the
  kernel routes (rtol 1e-4, atol 1e-4, as the JAX test).
* The port's packed net against the JAX package's packed net on the same
  params (``params_from_jax``), the default executor on both sides: f32
  within rtol 1e-4, atol 1e-5 (sums in another order); bf16 within 1e-2
  relative L2 (bf16 rounding of each layer's output, in another order).
* Packed pooling over r_in, r_out in {1, 2, 4}, max and average, at
  ceil-mode edges: equal to ``pack_nhwc`` of the port's unpacked pool
  everywhere (Caffe's divisor), and to the JAX function wherever no window
  is clipped (the JAX package divides by kh*kw).
* The narrow ResNet packed in LOWERED_SPARSE with ELL, element-wise 90%,
  against the JAX net (f32, rtol 1e-4, atol 1e-5).
* LRN on the packed layout (tests/test_pack_pass.py's LRN and GoogLeNet
  cases): ``lrn_across_channels(groups=2)`` on a packed map equals the
  packed logical LRN and the JAX function (rtol 1e-5, atol 1e-5); a
  GoogLeNet-shaped stem chain packs through pool -> LRN -> convs -> LRN ->
  pool as the JAX pass packs it and computes the unpacked net (rtol 1e-4,
  atol 1e-5); fused GoogLeNet packs its stem chain (at least 5 blobs,
  ``pool1/3x3_s2`` among them), after the s2d fold too.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.engine.context import SparseFormat as JSparseFormat  # noqa: E402
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.models import resnet as jresnet  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JLayerSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fold_stem_s2d as jfold  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.nn.fuse import pack_narrow_chains as jpack  # noqa: E402
from caffe_escoin_tpu.ops import norm as jnorm  # noqa: E402
from caffe_escoin_tpu.ops import pool as jpool  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import (ConvMode,  # noqa: E402
                                                   ExecutionPolicy,
                                                   SparseFormat)
from caffe_escoin_tpu_torch.models import ZOO, resnet  # noqa: E402
from caffe_escoin_tpu_torch.nn import (LayerSpec, Net, fuse_inference,  # noqa: E402
                                       params_from_jax)
from caffe_escoin_tpu_torch.nn.fuse import (fold_stem_s2d,  # noqa: E402
                                            pack_narrow_chains)
from caffe_escoin_tpu_torch.ops import norm as norm_ops  # noqa: E402
from caffe_escoin_tpu_torch.ops import pool as pool_ops  # noqa: E402
from caffe_escoin_tpu_torch.ops import wpack  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import (prune_conv_weight,  # noqa: E402
                                                  prune_magnitude)
from test_torch_net import _narrow_resnet  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-5)
PACKED_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL_L2 = 1e-2


def _tower(spec):
    """Post-fusion bottleneck stage: stem -> reduce -> k3 ->
    expand(+residual) -> strided boundary conv (tests/test_pack_pass.py)."""
    return [
        spec(name="conv0", type="ConvolutionReLU", bottoms=("data",),
             tops=("s",), params=dict(num_output=8, kernel=1, pad=0)),
        spec(name="convA", type="ConvolutionReLU", bottoms=("s",),
             tops=("a",), params=dict(num_output=4, kernel=1, pad=0)),
        spec(name="convB", type="ConvolutionReLU", bottoms=("a",),
             tops=("b",), params=dict(num_output=4, kernel=3, pad=1)),
        spec(name="convC", type="Convolution", bottoms=("b", "s"),
             tops=("c",), params=dict(num_output=8, kernel=1, pad=0,
                                      fuse_add=True, fuse_relu=True)),
        spec(name="convD", type="Convolution", bottoms=("c",), tops=("d",),
             params=dict(num_output=8, kernel=1, pad=0, stride=2)),
    ]


def _pool_chain(spec, mode="max"):
    """conv -> 2x2/s2 pool -> conv -> strided 1x1 (the pool consumes and
    emits packed)."""
    return [
        spec(name="conv0", type="Convolution", bottoms=("data",),
             tops=("c0",), params=dict(num_output=4, kernel=3, pad=1)),
        spec(name="pool1", type="Pooling", bottoms=("c0",), tops=("p1",),
             params=dict(kernel=2, stride=2, mode=mode)),
        spec(name="conv1", type="Convolution", bottoms=("p1",),
             tops=("c1",), params=dict(num_output=4, kernel=3, pad=1)),
        spec(name="conv2", type="Convolution", bottoms=("c1",),
             tops=("c2",), params=dict(num_output=8, kernel=1, pad=0,
                                       stride=2)),
    ]


def _refusals(spec):
    """c0 feeds a global pool and b2 is a final top: neither can close its
    layout, so both stay unpacked, while a1 packs (its consumer's stride
    2 unpacks it)."""
    return [
        spec(name="conv0", type="Convolution", bottoms=("data",),
             tops=("c0",), params=dict(num_output=4, kernel=3, pad=1)),
        spec(name="gpool", type="Pooling", bottoms=("c0",), tops=("g",),
             params=dict(mode="avg", global_pooling=True)),
        spec(name="convA", type="Convolution", bottoms=("data",),
             tops=("a1",), params=dict(num_output=4, kernel=1, pad=0)),
        spec(name="convB", type="Convolution", bottoms=("a1",),
             tops=("b2",), params=dict(num_output=4, kernel=1, pad=0,
                                       stride=2)),
    ]


def _narrow(spec):
    return _narrow_resnet(resnet._conv_bn if spec is LayerSpec
                          else jresnet._conv_bn,
                          resnet._bottleneck if spec is LayerSpec
                          else jresnet._bottleneck, spec)


def _stem_chain(spec):
    """GoogLeNet-stem shape (tests/test_pack_pass.py): pool (packed out) ->
    LRN -> 1x1 -> 3x3 -> LRN -> pool/s2 (packed in, unpacked out)."""
    return [
        spec(name="conv1", type="ConvolutionReLU", bottoms=("data",),
             tops=("c1",), params=dict(num_output=4, kernel=3, pad=1,
                                       stride=2)),
        spec(name="pool1", type="Pooling", bottoms=("c1",), tops=("p1",),
             params=dict(kernel=3, stride=2)),
        spec(name="norm1", type="LRN", bottoms=("p1",), tops=("n1",),
             params=dict(local_size=3)),
        spec(name="reduce", type="ConvolutionReLU", bottoms=("n1",),
             tops=("rd",), params=dict(num_output=4, kernel=1, pad=0)),
        spec(name="conv2", type="ConvolutionReLU", bottoms=("rd",),
             tops=("c2",), params=dict(num_output=6, kernel=3, pad=1)),
        spec(name="norm2", type="LRN", bottoms=("c2",), tops=("n2",),
             params=dict(local_size=3)),
        spec(name="pool2", type="Pooling", bottoms=("n2",), tops=("p2",),
             params=dict(kernel=3, stride=2)),
        spec(name="convT", type="Convolution", bottoms=("p2",), tops=("t",),
             params=dict(num_output=8, kernel=1, pad=0)),
    ]


# name -> (function of a LayerSpec class giving the specs, input shape,
#          lanes)
SMALL = {
    "tower": (_tower, (2, 6, 16, 8), 8),
    "pool_chain": (_pool_chain, (2, 8, 16, 4), 8),
    "avg_pool_chain": (lambda s: _pool_chain(s, "avg"), (2, 8, 16, 4), 8),
    "refusals": (_refusals, (2, 6, 16, 4), 8),
    "narrow_resnet": (_narrow, (2, 32, 32, 3), 32),
    "stem_chain": (_stem_chain, (2, 18, 34, 3), 8),
}


def _jax_small(name, policy=None):
    build, shape, _ = SMALL[name]
    jnet = JNet(build(JLayerSpec), policy=policy or JPolicy(), phase="test")
    jparams = jnet.init(jax.random.PRNGKey(0), {"data": shape})
    return jnet, jparams


def _port_small(name, jparams, policy=None):
    """The port's net on the JAX params (and its blob shapes from init)."""
    build, shape, _ = SMALL[name]
    net = Net(build(LayerSpec), policy=policy or ExecutionPolicy())
    net.init(torch.Generator().manual_seed(0), {"data": shape})
    params, _ = params_from_jax(
        {k: {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in jparams.items()})
    return net, params


def _fused_small(name, jpol=None, pol=None, prune=None):
    """Both sides' fused nets (the narrow ResNet folds its BatchNorm; the
    rest have nothing to fold) on the same params, and their packed nets."""
    jnet, jparams = _jax_small(name, jpol)
    net, params = _port_small(name, jparams, pol)
    if prune is not None:
        params = {k: dict(v, w=torch.from_numpy(prune(v["w"].numpy())))
                  if "w" in v and prune(v["w"].numpy()) is not None else v
                  for k, v in params.items()}
        jparams = {k: {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
                   for k, v in params.items()}
    jfnet, jfparams = jfuse(jnet, jparams, state=jnet.state0)
    fnet, fparams = fuse_inference(net, params)
    lanes = SMALL[name][2]
    return dict(jfnet=jfnet, jfparams=jfparams, fnet=fnet, fparams=fparams,
                jpnet=jpack(jfnet, lanes=lanes),
                pnet=pack_narrow_chains(fnet, lanes=lanes))


def _zoo_fused(name, batch, block=None):
    """Fused ResNet-50 or VGG-16 on both sides from the port's blob shapes
    (a walk of the unfused net) and per-conv random weights (fold with
    unit statistics), pruned to 90% in ``block`` blocks where one is given
    (the 3-channel stems stay dense); nothing is initialised. Returns
    (input shapes, fused params on both sides, the fused nets)."""
    build, shapes = ZOO[name]
    shapes = {"data": (batch,) + tuple(shapes["data"][1:])}
    net = Net(build())
    blob_shapes = {}
    params = {}
    rng = np.random.default_rng(0)
    for layer, in_shapes in net.walk_shapes(shapes, blob_shapes):
        s = layer.spec
        if s.type in ("Convolution", "ConvolutionReLU"):
            k, cin = s.params["kernel"], in_shapes[0][-1]
            w = rng.standard_normal(
                (k, k, cin, s.params["num_output"])).astype(np.float32)
            if block is not None and cin >= 32:
                w = prune_conv_weight(w, 0.9, block)
            params[s.name] = {"w": w}
    net.blob_shapes = blob_shapes
    jnet = JNet(JZOO[name][0](), phase="test")
    jnet.blob_shapes = dict(blob_shapes)
    fnet, fparams = fuse_inference(
        net, {k: {"w": torch.from_numpy(v["w"])} for k, v in params.items()},
        state={})
    jfnet, jfparams = jfuse(jnet, {k: {"w": jnp.asarray(v["w"])}
                                   for k, v in params.items()}, state={})
    return shapes, (fparams, jfparams), fnet, jfnet


def _pack_params(net):
    return {s.name: {k: s.params[k] for k in ("pack_in", "pack_out",
                                               "pack_w") if k in s.params}
            for s in net.specs}


# -- structure -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(SMALL) + ["resnet50", "vgg16",
                                                 "googlenet"])
def test_pass_marks_what_the_jax_pass_marks(name):
    if name in SMALL:
        run = _fused_small(name)
        pnet, jpnet = run["pnet"], run["jpnet"]
    else:
        _, _, fnet, jfnet = _zoo_fused(name, 1)
        pnet, jpnet = pack_narrow_chains(fnet), jpack(jfnet)
    marked = getattr(pnet, "packed_blobs", {})
    assert marked == getattr(jpnet, "packed_blobs", {})
    assert _pack_params(pnet) == _pack_params(jpnet)
    assert pnet.blob_shapes == {k: tuple(v)
                                for k, v in jpnet.blob_shapes.items()}
    expect = {"tower": {"a": 2, "b": 2, "s": 2, "c": 2},
              "pool_chain": {"c0": 2, "p1": 2, "c1": 2},
              "refusals": {"a1": 2},
              # c1 (17 wide, odd) and p2 (a plain conv's input) stay
              # unpacked
              "stem_chain": dict.fromkeys(("p1", "n1", "rd", "c2", "n2"), 2)}
    if name in expect:
        assert marked == expect[name]
    if name == "resnet50":
        assert len(marked) == 12 and set(marked.values()) == {2}
        assert {"conv1_r", "pool1", "res2c_out"} <= set(marked)
    if name == "vgg16":
        assert marked == dict.fromkeys(
            ("conv1_1", "conv1_2", "pool1", "conv2_1", "conv2_2"), 2)
    if name == "googlenet":
        # the stem's output and the chain after it, through both LRNs (the
        # JAX test wants >= 5)
        assert marked == dict.fromkeys(
            ("conv1/7x7_s2", "pool1/3x3_s2", "pool1/norm1",
             "conv2/3x3_reduce", "conv2/3x3", "conv2/norm2"), 2)
    # the packed layers' own output shapes are the pass's packed shapes
    walked = {}
    for _ in pnet.walk_shapes({"data": pnet.blob_shapes["data"]}, walked):
        pass
    assert all(pnet.blob_shapes[b] == shp for b, shp in walked.items())


def test_tower_pack_params():
    run = _fused_small("tower")
    by_name = {s.name: s.params for s in run["pnet"].specs}
    assert (by_name["convA"]["pack_in"], by_name["convA"]["pack_out"]) == \
        (2, 2)
    assert by_name["convD"]["pack_in"] == 2
    assert by_name["convD"].get("pack_out", 1) == 1
    assert by_name["convC"]["pack_w"] == 16
    assert run["pnet"].blob_shapes["a"] == (2, 6, 8, 8)


def test_refusals_leave_the_net_unpacked_where_layout_cannot_close():
    run = _fused_small("refusals")
    by_name = {s.name: s.params for s in run["pnet"].specs}
    assert "pack_out" not in by_name["conv0"]  # c0 feeds a global pool
    assert by_name["convB"]["pack_in"] == 2
    assert by_name["convB"]["pack_out"] == 1  # b2 is a final top
    # a net where every narrow blob is refused comes back unchanged
    net = Net([LayerSpec("conv0", "Convolution", ("data",), ("c0",),
                         params=dict(num_output=4, kernel=3, pad=1))])
    net.init(torch.Generator().manual_seed(0), {"data": (1, 4, 8, 4)})
    assert pack_narrow_chains(net, lanes=8) is net


# -- packing is exact ------------------------------------------------------------

POLICIES = {
    "dense": None,
    "aligned": ExecutionPolicy(block_shape=(4, 4)),
    "kernel_routes": ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                                     block_shape=(4, 4),
                                     use_xla_sparse=False),
}


@pytest.mark.parametrize("path", list(POLICIES))
@pytest.mark.parametrize("name", ["tower", "pool_chain", "avg_pool_chain",
                                  "narrow_resnet", "stem_chain"])
def test_packed_equals_unpacked(name, path):
    pol = POLICIES[path]
    run = _fused_small(name, pol=pol or ExecutionPolicy())
    fnet, pnet, params = run["fnet"], run["pnet"], run["fparams"]
    assert pnet.packed_blobs
    if pol is not None:
        want_params, got_params = (fnet.weight_align(params),
                                   pnet.weight_align(params))
    else:
        want_params = got_params = params
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        SMALL[name][1]).astype(np.float32))
    want = fnet.apply(want_params, {"data": x})
    got = pnet.apply(got_params, {"data": x})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **PACKED_TOL)


# -- the port's packed net against the JAX package's ---------------------------

def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["tower", "pool_chain", "narrow_resnet",
                                  "stem_chain"])
def test_packed_net_matches_jax_packed_net(name, dtype):
    bf16 = dtype == "bf16"
    jpol = JPolicy(block_shape=(4, 4),
                   compute_dtype=jnp.bfloat16 if bf16 else None,
                   cast_back=not bf16)
    pol = ExecutionPolicy(block_shape=(4, 4),
                          compute_dtype=torch.bfloat16 if bf16 else None,
                          cast_back=not bf16)
    run = _fused_small(name, jpol=jpol, pol=pol)
    jpnet, pnet = run["jpnet"], run["pnet"]
    assert pnet.packed_blobs == jpnet.packed_blobs != {}
    x = np.random.default_rng(2).standard_normal(SMALL[name][1]).astype(
        np.float32)
    want = jpnet.apply(jpnet.weight_align(run["jfparams"]),
                       {"data": jnp.asarray(x)}, return_blobs=True)
    got = pnet.apply(pnet.weight_align(run["fparams"]),
                     {"data": torch.from_numpy(x)}, return_blobs=True)
    # every blob the port keeps, packed ones in the packed layout
    for k, blob in got.items():
        out, ref = blob.float().numpy(), np.asarray(want[k], np.float32)
        assert out.shape == ref.shape, k
        if bf16:
            assert _rel_l2(out, ref) <= BF16_REL_L2, k
        else:
            np.testing.assert_allclose(out, ref, err_msg=k, **F32_TOL)


# -- packed pooling ---------------------------------------------------------------

# (kernel, stride, pad): 2x2/s2, a ceil-extended 3x3/s2 edge, ResNet-50's
# pool1 with padding, stride 4 (sw != r_in), stride 1, and 3x3/s3 (the
# ceil-extended last window clipped in both dimensions)
POOL_GEOMS = [((2, 2), (2, 2), (0, 0)), ((3, 3), (2, 2), (0, 0)),
              ((3, 3), (2, 2), (1, 1)), ((3, 3), (4, 4), (1, 1)),
              ((3, 3), (1, 1), (1, 1)), ((3, 3), (3, 3), (1, 1))]
POOL_X = (2, 9, 16, 3)


def _pool_cases():
    cases = []
    for geom in POOL_GEOMS:
        (kh, kw), (sh, sw), (ph, pw) = geom
        wo = pool_ops._pooled_size(POOL_X[2], kw, sw, pw, True)
        for r_in in (1, 2, 4):
            for r_out in (1, 2, 4):
                if (sw * r_out) % r_in == 0 and wo % r_out == 0:
                    cases.append((geom, r_in, r_out))
    return cases


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("geom,r_in,r_out", _pool_cases())
def test_pool2d_packed_matches_caffe_and_jax(geom, r_in, r_out, mode):
    kernel, stride, padding = geom
    x = np.random.default_rng(5).standard_normal(POOL_X).astype(np.float32)
    xt = wpack.pack_nhwc(torch.from_numpy(x), r_in)
    kw = dict(stride=stride, padding=padding, mode=mode)
    got = pool_ops.pool2d_packed(xt, kernel, r_in=r_in, r_out=r_out, **kw)
    caffe = pool_ops.pool2d(torch.from_numpy(x), kernel, **kw)
    np.testing.assert_allclose(got.numpy(),
                               wpack.pack_nhwc(caffe, r_out).numpy(),
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(jpool.pool2d_packed(
        jnp.asarray(wpack.pack_nhwc(x, r_in)), kernel, r_in=r_in,
        r_out=r_out, **kw))
    # where a window runs past the padded input, Caffe (and the port)
    # divide by its part inside, the JAX package by kh*kw
    n, h, w, c = POOL_X
    ho, wo = caffe.shape[1:3]

    def whole(size, k, s, p, n_out):
        return np.arange(n_out) * s - p + k <= size + p

    keep = (whole(h, kernel[0], stride[0], padding[0], ho)[:, None]
            & whole(w, kernel[1], stride[1], padding[1], wo)[None, :])
    keep = np.broadcast_to(keep[None, :, :, None], (n, ho, wo, c))
    keep = wpack.pack_nhwc(np.ascontiguousarray(keep), r_out)
    if mode == "max":
        keep = np.ones_like(keep)
    np.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=1e-6,
                               atol=1e-6)
    if r_in == 1 and r_out > 1:
        np.testing.assert_array_equal(
            got.numpy(), pool_ops.pool2d_packed_out(
                torch.from_numpy(x), kernel, r=r_out, **kw).numpy())


def test_pool_cases_reach_clipped_windows_and_both_branches():
    """The grid holds clipped average windows (where JAX differs) and both
    W-pass branches (sw == r_in and the strided one)."""
    cases = _pool_cases()
    assert any(g[1][1] == r_in for g, r_in, _ in cases)
    assert any(g[1][1] != r_in for g, r_in, _ in cases if r_in > 1)
    x = torch.ones((1, 9, 16, 1))
    out = pool_ops.pool2d_packed(wpack.pack_nhwc(x, 2), (3, 3),
                                 stride=(3, 3), padding=(1, 1), mode="avg",
                                 r_in=2, r_out=2)
    jout = jpool.pool2d_packed(jnp.asarray(wpack.pack_nhwc(x.numpy(), 2)),
                               (3, 3), stride=(3, 3), padding=(1, 1),
                               mode="avg", r_in=2, r_out=2)
    # the last row's windows cover one real row of the two inside the
    # padded input: Caffe divides 3 ones by 2*3, the JAX package by 3*3
    assert out[0, -1, 1, 0].item() == pytest.approx(0.5)
    assert float(jout[0, -1, 1, 0]) == pytest.approx(1 / 3)


# -- LOWERED_SPARSE with ELL --------------------------------------------------------

def _prune_elementwise(w):
    if w.ndim == 2:
        return prune_magnitude(w, 0.9)
    if w.shape[2] < 8:
        return None  # the 3-channel stem stays dense
    return prune_conv_weight(w, 0.9, None)


def test_narrow_resnet_packed_ell_matches_jax():
    jpol = JPolicy(conv_mode=JConvMode.LOWERED_SPARSE, block_shape=(8, 8),
                   sparse_format=JSparseFormat.ELL)
    pol = ExecutionPolicy(conv_mode=ConvMode.LOWERED_SPARSE,
                          block_shape=(8, 8), sparse_format=SparseFormat.ELL)
    run = _fused_small("narrow_resnet", jpol=jpol, pol=pol,
                       prune=_prune_elementwise)
    pnet, jpnet = run["pnet"], run["jpnet"]
    assert pnet.packed_blobs == jpnet.packed_blobs != {}
    aligned = pnet.weight_align(run["fparams"])
    routes = pnet.routes(aligned, {"data": SMALL["narrow_resnet"][1]})
    assert routes["conv1"] == "dense" and "ell" in routes.values()
    x = np.random.default_rng(3).standard_normal(
        SMALL["narrow_resnet"][1]).astype(np.float32)
    want = jpnet.apply(jpnet.weight_align(run["jfparams"]),
                       {"data": jnp.asarray(x)})
    got = pnet.apply(aligned, {"data": torch.from_numpy(x)})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **F32_TOL)


# -- LRN on the packed layout ------------------------------------------------------

@pytest.mark.parametrize("groups", [2, 4])
def test_lrn_groups_matches_logical(groups):
    """tests/test_pack_pass.py's case, at r = 2 and 4: the masked windows of
    a packed map normalize each phase's channels as the logical LRN does,
    and as the JAX function does on the same packed map."""
    x = np.random.default_rng(6).standard_normal((2, 3, 8, 6)).astype(
        np.float32)
    want = norm_ops.lrn_across_channels(torch.from_numpy(x), local_size=5)
    xp = wpack.pack_nhwc(torch.from_numpy(x), groups)
    got = norm_ops.lrn_across_channels(xp, local_size=5, groups=groups)
    np.testing.assert_allclose(got.numpy(),
                               wpack.pack_nhwc(want, groups).numpy(),
                               rtol=1e-5, atol=1e-5)
    jgot = jnorm.lrn_across_channels(jnp.asarray(xp.numpy()), local_size=5,
                                     groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5,
                               atol=1e-5)


def test_stem_chain_packs_through_lrn_and_pool():
    """The LRN branches of the pass are live: both LRNs carry the packed
    layout at r = 2 (``pack_in``), pool1 emits it and pool2 ends it."""
    run = _fused_small("stem_chain")
    by_name = {s.name: s.params for s in run["pnet"].specs}
    assert by_name["pool1"]["pack_out"] == 2
    assert by_name["norm1"]["pack_in"] == 2
    assert by_name["norm2"]["pack_in"] == 2
    assert by_name["pool2"]["pack_in"] == 2
    assert by_name["pool2"].get("pack_out", 1) == 1
    assert run["pnet"].blob_shapes["n1"] == (2, 4, 4, 8)


def test_googlenet_stem_packs_after_the_s2d_fold():
    """bench.py's order on GoogLeNet (fuse, fold the stem, pack): the folded
    stem keeps its layout and the chain from pool1 to conv2/norm2 packs as
    without the fold, as the JAX passes do."""
    _, (fparams, jfparams), fnet, jfnet = _zoo_fused("googlenet", 1)
    snet, _ = fold_stem_s2d(fnet, fparams)
    jsnet, _ = jfold(jfnet, jfparams)
    jsnet.blob_shapes = dict(jfnet.blob_shapes)
    pnet, jpnet = pack_narrow_chains(snet), jpack(jsnet)
    assert pnet.packed_blobs == jpnet.packed_blobs
    assert len(pnet.packed_blobs) >= 5 and "pool1/3x3_s2" in pnet.packed_blobs
    assert _pack_params(pnet) == _pack_params(jpnet)
    assert "conv1/7x7_s2" not in pnet.packed_blobs
    stem = {s.name: s.params for s in pnet.specs}["conv1/7x7_s2"]
    assert stem["s2d_r"] == 2 and "pack_out" not in stem
