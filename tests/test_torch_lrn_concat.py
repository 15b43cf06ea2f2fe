"""The port's LRN (``ops/norm.lrn_across_channels``, ``LRNLayer``) and Concat
(``ops/structural.concat``, ``ConcatLayer``) against the JAX package's.

LRN: the same seeded NHWC inputs through both functions, for ``groups``
(the W-pair packed layout's lane blocks) in {1, 2, 4}, beta 0.75 (the
rsqrt form) and 0.5 (the power form), and odd and even window sizes. Both
compute in f32 with the window summed in the same order, so f32 agrees to
rtol 1e-5, atol 1e-6 (rsqrt and power may round differently), and bf16
(cast back at the end) to one bf16 ulp, rtol 8e-3. ``F.local_response_norm``
(NCHW, through ``avg_pool3d``) is a second oracle for ``groups=1``, rtol
1e-4, atol 1e-6 (another order of the sums). Concat is a copy: equal.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.nn import LayerSpec as JLayerSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.ops import norm as jnorm  # noqa: E402
from caffe_escoin_tpu.ops import structural as jstruct  # noqa: E402

from caffe_escoin_tpu_torch.nn import LayerSpec, Net, params_from_jax  # noqa: E402
from caffe_escoin_tpu_torch.ops import norm as norm_ops  # noqa: E402
from caffe_escoin_tpu_torch.ops import structural as struct_ops  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=8e-3, atol=0.0)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _x(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("beta", [0.75, 0.5])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("local_size", [5, 4])
def test_lrn_matches_jax(groups, beta, dtype, local_size):
    tdt, jdt = DTYPES[dtype]
    x = _x((2, 5, 6, 24))
    kw = dict(local_size=local_size, alpha=1e-2, beta=beta, k=2.0)
    got = norm_ops.lrn_across_channels(torch.from_numpy(x).to(tdt),
                                       groups=groups, **kw)
    want = jnorm.lrn_across_channels(jnp.asarray(x, jdt), groups=groups, **kw)
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "f32" else BF16_TOL))


@pytest.mark.parametrize("beta", [0.75, 0.5])
def test_lrn_matches_torch_local_response_norm(beta):
    x = _x((2, 7, 5, 16), seed=1)
    got = norm_ops.lrn_across_channels(torch.from_numpy(x), local_size=5,
                                       alpha=1e-2, beta=beta, k=1.0)
    ref = F.local_response_norm(torch.from_numpy(x).permute(0, 3, 1, 2), 5,
                                alpha=1e-2, beta=beta, k=1.0)
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-4, atol=1e-6)


def test_lrn_masks_are_built_once_per_shape_and_device():
    """A packed LRN reuses its lane masks across calls (a tensor built
    inside a forward would break CUDA-graph capture on the card)."""
    x = torch.from_numpy(_x((1, 2, 3, 12), seed=2))
    norm_ops.lrn_across_channels(x, local_size=5, groups=2)
    misses = norm_ops._lrn_mask.cache_info().misses
    norm_ops.lrn_across_channels(x, local_size=5, groups=2)
    assert norm_ops._lrn_mask.cache_info().misses == misses
    mask = norm_ops._lrn_mask(12, 2, -2, x.device)
    assert mask is norm_ops._lrn_mask(12, 2, -2, x.device)
    # lanes 0-1 of each 6-lane group have no channel two below them
    assert mask.tolist() == [0, 0, 1, 1, 1, 1] * 2


def _lrn_specs(spec):
    return [spec("norm", "LRN", ("data",), ("n",),
                 params=dict(local_size=5, alpha=1e-4, beta=0.75))]


def test_lrn_layer_matches_jax_layer():
    x = _x((2, 6, 6, 32), seed=3, scale=30.0)
    want = JNet(_lrn_specs(JLayerSpec)).apply({}, {"data": jnp.asarray(x)})
    got = Net(_lrn_specs(LayerSpec)).apply({}, {"data": torch.from_numpy(x)})
    np.testing.assert_allclose(got["n"].numpy(), np.asarray(want["n"]),
                               **F32_TOL)


@pytest.mark.parametrize("axis", [-1, 1, 3])
def test_concat_matches_jax(axis):
    rng = np.random.default_rng(4)
    shapes = [(2, 4, 5, 3), (2, 4, 5, 7), (2, 4, 5, 2)]
    if axis == 1:
        shapes = [(2, 3, 5, 6), (2, 1, 5, 6), (2, 4, 5, 6)]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    got = struct_ops.concat([torch.from_numpy(x) for x in xs], axis=axis)
    want = jstruct.concat([jnp.asarray(x) for x in xs], axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _concat_specs(spec, axis=None):
    params = {} if axis is None else dict(axis=axis)
    return [
        spec("a", "Convolution", ("data",), params=dict(num_output=3,
                                                        kernel=1)),
        spec("b", "Convolution", ("data",), params=dict(num_output=5,
                                                        kernel=3, pad=1)),
        spec("pool", "Pooling", ("data",), params=dict(kernel=3, stride=1,
                                                       pad=1)),
        spec("out", "Concat", ("a", "b", "pool"), params=params),
    ]


@pytest.mark.parametrize("axis", [None, 3])
def test_concat_layer_shapes_and_forward_match_jax(axis):
    """``ConcatLayer.out_shapes`` gives the summed channels, so that
    ``walk_shapes`` (and with it ``blob_shapes`` and ``Net.routes``) sees
    what the forward makes; the forward on the JAX net's params equals the
    JAX net's."""
    shape = (2, 6, 7, 4)
    jnet = JNet(_concat_specs(JLayerSpec, axis))
    jparams = jnet.init(jax.random.PRNGKey(0), {"data": shape})
    net = Net(_concat_specs(LayerSpec, axis))
    net.init(torch.Generator().manual_seed(0), {"data": shape})
    assert net.blob_shapes["out"] == (2, 6, 7, 12)
    assert net.blob_shapes == {k: tuple(v) for k, v in
                               jnet.blob_shapes.items()}
    params, _ = params_from_jax(jparams)
    x = _x(shape, seed=5)
    got = net.apply(params, {"data": torch.from_numpy(x)})["out"]
    want = jnet.apply(jparams, {"data": jnp.asarray(x)})["out"]
    assert tuple(got.shape) == net.blob_shapes["out"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
