"""The port's space-to-depth stem fold (``ops/s2d.py``,
``nn/fuse.fold_stem_s2d``, the s2d branch of ``ConvolutionLayer``), a mirror
of tests/test_s2d.py.

* Exactness: the remapped stride-1 conv over the s2d layout gives the
  strided conv (``F.conv2d``, f32, rtol 1e-5, atol 1e-4: sums of up to
  363 products of unit normals in another order) for every stem
  geometry of the zoo (7x7/s2/p3, 11x11/s4/p0) and adversarial ones (H not
  divisible by r, pad > r, k < r), and the remapped weight equals the JAX
  package's ``s2d_weight`` exactly. Where the reference is right (its
  far-end amount is not negative), ``s2d_input`` equals its function.
* The reference's fault (its ``ops/s2d.py:53`` clamps a needed crop to 0):
  21x21 with k=2, r=2, p=0 and 22x22 with k=3, r=3, p=0 give the strided
  conv's shape and values here; a net whose k <= r stem is folded stays
  equal to the unfolded net.
* The pass: only net-input convs with a square stride >= 2 and
  cin*r^2 <= 128 fold, as the JAX pass marks them; the folded net equals
  the unfolded one, dense and aligned (rtol 1e-4, atol 1e-4), and the JAX
  folded net on the same params (f32, rtol 1e-4, atol 1e-5); its shapes
  and routes see the s2d input; the pack pass skips s2d convs; the fold
  runs after ``fuse_inference``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.nn import LayerSpec as JLayerSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fold_stem_s2d as jfold  # noqa: E402
from caffe_escoin_tpu.ops import s2d as js2d  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import (ConvMode,  # noqa: E402
                                                   ExecutionPolicy)
from caffe_escoin_tpu_torch.nn import (LayerSpec, Net,  # noqa: E402
                                       fuse_inference, params_from_jax)
from caffe_escoin_tpu_torch.nn.fuse import (fold_stem_s2d,  # noqa: E402
                                            pack_narrow_chains)
from caffe_escoin_tpu_torch.ops import conv as conv_ops  # noqa: E402
from caffe_escoin_tpu_torch.ops import s2d  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight  # noqa: E402

EXACT = dict(rtol=1e-5, atol=1e-4)


def _strided(x, w, r, p):
    """The strided conv the fold replaces: NHWC x, HWIO w."""
    return F.conv2d(torch.as_tensor(x).permute(0, 3, 1, 2),
                    torch.as_tensor(w).permute(3, 2, 0, 1), stride=r,
                    padding=p).permute(0, 2, 3, 1)


def _folded(x, w, r, k, p):
    wp = s2d.s2d_weight(w, r, (p, p))
    xs = s2d.s2d_input(torch.as_tensor(x), r, (k, k), (p, p))
    return F.conv2d(xs.permute(0, 3, 1, 2),
                    torch.from_numpy(wp).permute(3, 2, 0, 1)).permute(
                        0, 2, 3, 1), wp


@pytest.mark.parametrize("ish,k,r,p", [
    ((2, 56, 56, 3), 7, 2, 3),     # GoogLeNet/ResNet conv1 geometry
    ((2, 59, 59, 3), 11, 4, 0),    # AlexNet conv1 (H not divisible by r)
    ((2, 20, 20, 5), 5, 3, 2),
    ((2, 21, 21, 2), 3, 2, 0),
    ((2, 16, 16, 3), 2, 2, 0),     # k == r
    ((1, 30, 30, 4), 9, 3, 4),     # pad > r
    ((2, 17, 17, 3), 1, 2, 0),     # k < r
])
def test_s2d_weight_exact(ish, k, r, p):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((k, k, ish[-1], 8)).astype(np.float32)
    x = rng.standard_normal(ish).astype(np.float32)
    y0 = _strided(x, w, r, p)
    y1, wp = _folded(x, w, r, k, p)
    assert y0.shape == y1.shape
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), **EXACT)
    np.testing.assert_array_equal(wp, js2d.s2d_weight(w, r, (p, p)))
    kp, pl, ph, out, grid = s2d.s2d_axis_geometry(k, r, p, ish[1])
    if ph >= 0:  # the reference's own geometry is right here
        assert js2d.s2d_axis_geometry(k, r, p, ish[1]) == (kp, pl, ph, out,
                                                           grid)
        np.testing.assert_array_equal(
            s2d.s2d_input(torch.from_numpy(x), r, (k, k), (p, p)).numpy(),
            np.asarray(js2d.s2d_input(jnp.asarray(x), r, (k, k), (p, p))))


@pytest.mark.parametrize("ish,k,r", [((2, 21, 21, 2), 2, 2),
                                     ((2, 22, 22, 2), 3, 3)])
def test_reference_fault_cases_give_the_strided_conv(ish, k, r):
    """The two cases where the reference's grid keeps one position too
    many (11x11 for a 10x10 conv, 8x8 for 7x7): the grid is cropped, and
    the result is the strided conv's shape and values."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((k, k, ish[-1], 8)).astype(np.float32)
    x = rng.standard_normal(ish).astype(np.float32)
    y0 = _strided(x, w, r, 0)
    y1, _ = _folded(x, w, r, k, 0)
    assert y1.shape == y0.shape == (2, (ish[1] - k) // r + 1,
                                    (ish[2] - k) // r + 1, 8)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), **EXACT)
    assert s2d.s2d_axis_geometry(k, r, 0, ish[1])[2] == -1


def test_s2d_weight_preserves_zero_structure():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((7, 7, 3, 8)).astype(np.float32)
    w[:, :, :, 4:] = 0.0  # a pruned output block
    wp = s2d.s2d_weight(w, 2, (3, 3))
    assert np.all(wp[:, :, :, 4:] == 0.0)
    assert np.count_nonzero(wp) == np.count_nonzero(w)


def _stem_specs(spec, k=7, r=2, p=3):
    return [
        spec(name="conv1", type="ConvolutionReLU", bottoms=("data",),
             tops=("c1",), params=dict(num_output=16, kernel=k, stride=r,
                                       pad=p)),
        spec(name="pool1", type="Pooling", bottoms=("c1",), tops=("p1",),
             params=dict(kernel=3, stride=2)),
        spec(name="conv2", type="ConvolutionReLU", bottoms=("p1",),
             tops=("c2",), params=dict(num_output=16, kernel=3, stride=1,
                                       pad=1)),
    ]


def _build(policy=None, shape=(2, 32, 32, 3), **geom):
    """The stem net on both sides, on the JAX net's params."""
    jnet = JNet(_stem_specs(JLayerSpec, **geom), phase="test")
    jparams = jnet.init(jax.random.PRNGKey(0), {"data": shape})
    net = Net(_stem_specs(LayerSpec, **geom),
              policy=policy or ExecutionPolicy())
    net.init(torch.Generator().manual_seed(0), {"data": shape})
    params, _ = params_from_jax(jparams)
    return net, params, jnet, jparams, shape


def _x(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_fold_stem_s2d_marks_only_input_conv():
    net, params, jnet, jparams, _ = _build()
    fnet, fparams = fold_stem_s2d(net, params)
    by_name = {s.name: s.params for s in fnet.specs}
    assert by_name["conv1"]["s2d_r"] == 2
    assert by_name["conv1"]["kernel"] == [4, 4]
    assert by_name["conv1"]["stride"] == 1 and by_name["conv1"]["pad"] == 0
    assert "s2d_r" not in by_name["conv2"]
    assert tuple(fparams["conv1"]["w"].shape) == (4, 4, 12, 16)
    jfnet, jfparams = jfold(jnet, jparams)
    assert [s.params for s in fnet.specs] == [s.params for s in jfnet.specs]
    np.testing.assert_array_equal(fparams["conv1"]["w"].numpy(),
                                  np.asarray(jfparams["conv1"]["w"]))


def test_folded_net_shapes_and_routes_see_the_s2d_input():
    """``out_shapes`` runs the remapped conv on the s2d grid: the folded
    net's blobs keep the unfolded net's shapes; ``route`` names the route
    of the conv at the s2d shape."""
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(8, 8),
                          use_xla_sparse=False)
    net, params, _, _, shape = _build(pol)
    # prune the stem so that it has a sparse route to name
    params["conv1"] = dict(params["conv1"], w=torch.from_numpy(
        prune_conv_weight(params["conv1"]["w"].numpy(), 0.9, None)))
    fnet, fparams = fold_stem_s2d(net, params)
    walked = {}
    for _ in fnet.walk_shapes({"data": shape}, walked):
        pass
    assert walked == net.blob_shapes
    aligned = fnet.weight_align(fparams)
    xs = s2d.s2d_input(torch.empty(shape, device="meta"), 2, (7, 7), (3, 3))
    assert tuple(xs.shape) == (2, 19, 19, 12)
    want = conv_ops.conv_route(xs, aligned["conv1"], policy=pol)
    assert fnet.routes(aligned, {"data": shape})["conv1"] == want != "dense"


def test_fold_stem_s2d_net_equality_dense_and_aligned():
    net, params, jnet, jparams, shape = _build()
    x = _x(shape)
    ref = net.apply(params, {"data": torch.from_numpy(x)})["c2"]
    fnet, fparams = fold_stem_s2d(net, params)
    out = fnet.apply(fparams, {"data": torch.from_numpy(x)})["c2"]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **EXACT)
    out_a = fnet.apply(fnet.weight_align(fparams),
                       {"data": torch.from_numpy(x)})["c2"]
    np.testing.assert_allclose(out_a.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    jfnet, jfparams = jfold(jnet, jparams)
    want = jfnet.apply(jfparams, {"data": jnp.asarray(x)})["c2"]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("shape,k,r", [((2, 21, 21, 3), 2, 2),
                                       ((2, 22, 22, 3), 3, 3)])
def test_fold_of_a_k_le_r_stem_is_exact(shape, k, r):
    """A stem with k <= r folds (there is no k > r guard) and the folded
    net gives the unfolded net, where the reference's fold would not."""
    net, params, _, _, _ = _build(shape=shape, k=k, r=r, p=0)
    fnet, fparams = fold_stem_s2d(net, params)
    assert fnet.specs[0].params["s2d_r"] == r
    x = torch.from_numpy(_x(shape, seed=4))
    ref = net.apply(params, {"data": x}, return_blobs=True)
    out = fnet.apply(fparams, {"data": x}, return_blobs=True)
    assert out["c1"].shape == ref["c1"].shape
    for blob in ("c1", "c2"):
        np.testing.assert_allclose(out[blob].numpy(), ref[blob].numpy(),
                                   **EXACT)


def test_fold_stem_s2d_skips_wide_or_unit_stride():
    specs = [
        LayerSpec(name="convA", type="Convolution", bottoms=("data",),
                  tops=("a",), params=dict(num_output=8, kernel=3, stride=1,
                                           pad=1)),
        LayerSpec(name="convB", type="Convolution", bottoms=("wide",),
                  tops=("b",), params=dict(num_output=8, kernel=3, stride=2,
                                           pad=1)),
        LayerSpec(name="convC", type="Convolution", bottoms=("a",),
                  tops=("c",), params=dict(num_output=8, kernel=3, stride=2,
                                           pad=1)),
        LayerSpec(name="convD", type="Convolution", bottoms=("data",),
                  tops=("d",), params=dict(num_output=8, kernel=3, stride=2,
                                           pad=1, group=3)),
    ]
    net = Net(specs)
    params = net.init(torch.Generator().manual_seed(0),
                      {"data": (1, 8, 8, 3), "wide": (1, 16, 16, 64)})
    fnet, fparams = fold_stem_s2d(net, params)
    # unit stride; 64*4 > 128 lanes; not a net input; grouped
    assert fnet is net and fparams is params
    assert all("s2d_r" not in s.params for s in fnet.specs)


def test_pack_pass_skips_s2d_convs():
    net, params, _, _, _ = _build()
    fnet, _ = fold_stem_s2d(net, params)
    pnet = pack_narrow_chains(fnet, lanes=32)
    by_name = {s.name: s.params for s in pnet.specs}
    assert "pack_out" not in by_name["conv1"]
    assert "pack_in" not in by_name["conv1"]


def test_fold_after_fuse_inference_googlenet_stem():
    """The deployment order: fuse, then fold, on a BatchNorm-bearing stem;
    the folded net equals the unfused one (rtol 1e-4, atol 1e-4)."""
    specs = [
        LayerSpec(name="conv1", type="Convolution", bottoms=("data",),
                  tops=("c1",), params=dict(num_output=8, kernel=7, stride=2,
                                            pad=3)),
        LayerSpec(name="bn1", type="BatchNorm", bottoms=("c1",),
                  tops=("b1",), params=dict(use_global_stats=True)),
        LayerSpec(name="relu1", type="ReLU", bottoms=("b1",), tops=("r1",)),
        LayerSpec(name="conv2", type="Convolution", bottoms=("r1",),
                  tops=("c2",), params=dict(num_output=8, kernel=1)),
    ]
    net = Net(specs)
    shape = (2, 16, 16, 3)
    params = net.init(torch.Generator().manual_seed(0), {"data": shape})
    state = {"bn1": {"mean_acc": torch.linspace(-1, 1, 8) * 3.0,
                     "var_acc": torch.linspace(1, 2, 8) * 3.0,
                     "count": torch.tensor(3.0)}}
    x = torch.from_numpy(_x(shape, seed=3))
    ref = net.apply(params, {"data": x}, state=state)["c2"]
    fnet, fparams = fuse_inference(net, params, state=state)
    snet, sparams = fold_stem_s2d(fnet, fparams)
    assert snet.specs[0].params["s2d_r"] == 2
    assert snet.specs[0].params["fuse_relu"]
    out = snet.apply(sparams, {"data": x})["c2"]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
