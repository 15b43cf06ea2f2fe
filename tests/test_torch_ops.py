"""Port parity: the ops of the slice (caffe_escoin_tpu_torch.ops) against
the JAX package's ops on the same numpy inputs, rtol 1e-4, atol 1e-5
(f32 on both sides; only the order of the sums differs). The JAX side
forces its Pallas kernels in interpret mode (``use_xla_sparse=False``)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.ops import activations as jact  # noqa: E402
from caffe_escoin_tpu.ops import conv as jconv  # noqa: E402
from caffe_escoin_tpu.ops import linear as jlinear  # noqa: E402
from caffe_escoin_tpu.ops import norm as jnorm  # noqa: E402
from caffe_escoin_tpu.ops import pool as jpool  # noqa: E402
from caffe_escoin_tpu.ops import structural as jstruct  # noqa: E402
from caffe_escoin_tpu.sparse import dense_to_bsc as jdense_to_bsc  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_fused  # noqa: E402
from caffe_escoin_tpu_torch.ops import activations, conv, linear, norm, pool  # noqa: E402
from caffe_escoin_tpu_torch.ops import structural  # noqa: E402
from caffe_escoin_tpu_torch.sparse import dense_to_bsc  # noqa: E402
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,  # noqa: E402
                                                  prune_conv_weight)

TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK = (16, 16)


def _jpol(mode):
    return JPolicy(conv_mode=JConvMode(int(mode)), block_shape=BLOCK,
                   use_pallas=True, interpret=True, mxu_dtype="float32",
                   use_xla_sparse=False)


# (mode, kernel, stride, pad, relu, residual, route counter)
CONV_CASES = {
    "gemm_3x3": (ConvMode.LOWERED_GEMM, 3, 1, 1, True, False, None),
    "gemm_3x3_s2_residual": (ConvMode.LOWERED_GEMM, 3, 2, 1, True, True, None),
    "lowered_3x3": (ConvMode.LOWERED_SPARSE, 3, 1, 1, False, False, "spmm"),
    "lowered_3x3_s2_residual": (ConvMode.LOWERED_SPARSE, 3, 2, 1, True, True,
                                "spmm"),
    "sconv_par_3x3": (ConvMode.SCONV_PAR, 3, 1, 1, True, False, "sconv"),
    "sconv_par_3x3_residual": (ConvMode.SCONV_PAR, 3, 1, 1, True, True,
                               "sconv"),
    "sconv_par_1x1_s2_subsample": (ConvMode.SCONV_PAR, 1, 2, 0, True, False,
                                   "sconv"),
    "sconv_par_3x3_s2_lowered": (ConvMode.SCONV_PAR, 3, 2, 1, False, False,
                                 "spmm"),
    "sconv_1x1": (ConvMode.SCONV, 1, 1, 0, False, True, "sconv"),
}


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_conv2d_modes(name):
    mode, k, s, p, relu, with_res, route = CONV_CASES[name]
    rng = np.random.default_rng(11)
    cin, cout, hw = 32, 48, 9
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = prune_conv_weight(rng.standard_normal((k, k, cin, cout)).astype(
        np.float32) * 0.1, 0.75, BLOCK)
    b = rng.standard_normal(cout).astype(np.float32)
    ho = (hw + 2 * p - k) // s + 1
    res = rng.standard_normal((2, ho, ho, cout)).astype(np.float32) \
        if with_res else None
    jpol = _jpol(mode)
    ref = jconv.conv2d(jnp.asarray(x), jweight_align(w, b, policy=jpol),
                       stride=(s, s), padding=(p, p), relu=relu,
                       policy=jpol,
                       residual=None if res is None else jnp.asarray(res))
    pol = ExecutionPolicy(conv_mode=mode, block_shape=BLOCK,
                          use_xla_sparse=False)
    counts = (sconv_fused.calls, bsc_spmm.calls)
    out = conv.conv2d(torch.from_numpy(x), weight_align(w, b, policy=pol),
                      stride=(s, s), padding=(p, p), relu=relu, policy=pol,
                      residual=None if res is None else torch.from_numpy(res))
    moved = (sconv_fused.calls - counts[0], bsc_spmm.calls - counts[1])
    assert moved == {None: (0, 0), "sconv": (1, 0), "spmm": (0, 1)}[route]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# (mode, kernel, stride, pad, relu, residual, forced arm, expected route)
XBSP_CASES = {
    "lowered_3x3_residual": (ConvMode.LOWERED_SPARSE, 3, 1, 1, True, True,
                             "auto", "xbsp_lowered"),
    "sconv_par_3x3_unroll": (ConvMode.SCONV_PAR, 3, 1, 1, True, False,
                             "auto", "unroll"),
    "sconv_3x3_residual_per_image": (ConvMode.SCONV, 3, 1, 1, True, True,
                                     "auto", "unroll"),
    "sconv_par_1x1_s2_subsample": (ConvMode.SCONV_PAR, 1, 2, 0, False, True,
                                   "gathered_cols", "gathered_cols"),
    "sconv_par_3x3_s2_dense": (ConvMode.SCONV_PAR, 3, 2, 1, True, False,
                               "auto", "dense"),
    "sconv_gathered_residual": (ConvMode.SCONV, 1, 1, 0, True, True,
                                "gathered", "gathered"),
    "sconv_par_forced_dense": (ConvMode.SCONV_PAR, 3, 1, 1, False, True,
                               "dense", "dense"),
    "sconv_par_forced_fused": (ConvMode.SCONV_PAR, 3, 1, 1, True, True,
                               "fused", "fused"),
}


@pytest.mark.parametrize("name", list(XBSP_CASES))
def test_conv2d_xbsp_modes(name):
    """The default policy's XBSP branch against the JAX dispatcher's (its
    Pallas fused kernel in interpret mode where an arm is forced to it)."""
    mode, k, s, p, relu, with_res, arm, route = XBSP_CASES[name]
    rng = np.random.default_rng(12)
    cin, cout, hw = 32, 48, 9
    x = rng.standard_normal((3, hw, hw, cin)).astype(np.float32)
    w = prune_conv_weight(rng.standard_normal((k, k, cin, cout)).astype(
        np.float32) * 0.1, 0.9, (8, 8))
    b = rng.standard_normal(cout).astype(np.float32)
    ho = (hw + 2 * p - k) // s + 1
    res = rng.standard_normal((3, ho, ho, cout)).astype(np.float32) \
        if with_res else None
    jpol = JPolicy(conv_mode=JConvMode(int(mode)), block_shape=(8, 8),
                   xbsp_arm=arm, interpret=True, mxu_dtype="float32")
    ref = jconv.conv2d(jnp.asarray(x), jweight_align(w, b, policy=jpol),
                       stride=(s, s), padding=(p, p), relu=relu, policy=jpol,
                       residual=None if res is None else jnp.asarray(res))
    pol = ExecutionPolicy(conv_mode=mode, block_shape=(8, 8), xbsp_arm=arm)
    al = weight_align(w, b, policy=pol)
    xt = torch.from_numpy(x)
    assert conv.conv_route(xt, al, stride=(s, s), padding=(p, p),
                           policy=pol) == route
    counts = (sconv_fused.calls, bsc_spmm.calls)
    out = conv.conv2d(xt, al, stride=(s, s), padding=(p, p), relu=relu,
                      policy=pol,
                      residual=None if res is None else torch.from_numpy(res))
    moved = (sconv_fused.calls - counts[0], bsc_spmm.calls - counts[1])
    assert moved == ((1, 0) if route == "fused" else (0, 0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("relu", [False, True])
def test_linear_sparse_xbsp(relu):
    """The default policy's fc: the XBSP spmm, no kernel entry."""
    rng = np.random.default_rng(4)
    w = prune_blocks(rng.standard_normal((64, 40)).astype(np.float32), 0.75,
                     BLOCK)
    b = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    ref = jlinear.linear_sparse(jnp.asarray(x), jdense_to_bsc(w, BLOCK),
                                jnp.asarray(b), relu=relu)
    calls = bsc_spmm.calls
    out = linear.linear_sparse(torch.from_numpy(x), dense_to_bsc(w, BLOCK),
                               torch.from_numpy(b), relu=relu)
    assert bsc_spmm.calls == calls
    assert out.shape == (2, 3, 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_im2col_matches():
    x = np.random.default_rng(0).standard_normal((2, 7, 6, 5)).astype(
        np.float32)
    kw = dict(stride=(2, 1), padding=(1, 2), dilation=(1, 2))
    ref, hw_ref = jconv.im2col(jnp.asarray(x), (3, 2), **kw)
    out, hw = conv.im2col(torch.from_numpy(x), (3, 2), **kw)
    assert hw == hw_ref
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


POOL_CASES = {
    "max_3x3_s2_ceil": dict(kernel=(3, 3), stride=(2, 2), mode="max", hw=16),
    # ceil rule extends past the edge, then drops the window that would
    # start in the padding (_pooled_size: 5 -> 2, not 3)
    "max_3x3_s3_p1_drop": dict(kernel=(3, 3), stride=(3, 3), padding=(1, 1),
                               mode="max", hw=5),
    # its last row and column of windows run past the padded input: held to
    # Caffe's divisor (_caffe_avg_pool), where JAX divides by kh*kw
    "avg_3x3_s2_p1": dict(kernel=(3, 3), stride=(2, 2), padding=(1, 1),
                          mode="avg", hw=8, caffe=True),
    # cifar10_quick's pool2 and pool3 (caffe_escoin_tpu/models/cifar.py)
    "avg_3x3_s2_cifar_pool2": dict(kernel=(3, 3), stride=(2, 2), mode="avg",
                                   hw=16, caffe=True),
    "avg_3x3_s2_cifar_pool3": dict(kernel=(3, 3), stride=(2, 2), mode="avg",
                                   hw=8, caffe=True),
    "avg_2x2_floor": dict(kernel=(2, 2), stride=(2, 2), mode="avg", hw=7,
                          ceil_mode=False),
    "global_avg": dict(kernel=(1, 1), mode="avg", global_pool=True, hw=7),
    "global_max": dict(kernel=(1, 1), mode="max", global_pool=True, hw=7),
}


def _caffe_avg_pool(x, kernel, stride, padding=(0, 0)):
    """Caffe's AVE pooling (pooling_layer.cpp), in numpy: ceil sizing with
    the last window starting inside the padded input, and each window
    divided by its size clipped at the input plus padding."""
    n, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding

    def pooled(size, k, s, p):
        out = -(-(size + 2 * p - k) // s) + 1
        return out - 1 if p and (out - 1) * s >= size + p else out

    ho, wo = pooled(h, kh, sh, ph), pooled(w, kw, sw, pw)
    out = np.zeros((n, ho, wo, c), np.float64)
    for i in range(ho):
        for j in range(wo):
            hs, ws = i * sh - ph, j * sw - pw
            he, we = min(hs + kh, h + ph), min(ws + kw, w + pw)
            size = (he - hs) * (we - ws)
            hs, ws, he, we = max(hs, 0), max(ws, 0), min(he, h), min(we, w)
            out[:, i, j] = x[:, hs:he, ws:we].sum(axis=(1, 2)) / size
    return out.astype(np.float32)


@pytest.mark.parametrize("name", list(POOL_CASES))
def test_pool2d(name):
    """Against the JAX function, or where a window runs past the padded
    input (``caffe``), against Caffe's rule, which JAX does not follow."""
    kw = dict(POOL_CASES[name])
    hw = kw.pop("hw")
    kernel = kw.pop("kernel")
    caffe = kw.pop("caffe", False)
    x = np.random.default_rng(3).standard_normal((2, hw, hw, 4)).astype(
        np.float32)
    jax_out = np.asarray(jpool.pool2d(jnp.asarray(x), kernel, **kw))
    out = pool.pool2d(torch.from_numpy(x), kernel, **kw).numpy()
    if caffe:
        ref = _caffe_avg_pool(x, kernel, kw["stride"],
                              kw.get("padding", (0, 0)))
        # the case reaches a window JAX divides by the full kernel size
        assert not np.allclose(jax_out, ref, **TOL)
    else:
        ref = jax_out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


def test_pooled_size_drops_window_starting_in_padding():
    assert pool._pooled_size(5, 3, 3, 1, True) == 2
    assert pool._pooled_size(5, 3, 3, 1, True) == jpool._pooled_size(
        5, 3, 3, 1, True)


@pytest.mark.parametrize("relu", [False, True])
def test_linear_sparse(relu):
    rng = np.random.default_rng(4)
    w = prune_blocks(rng.standard_normal((64, 40)).astype(np.float32), 0.75,
                     BLOCK)
    b = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    ref = jlinear.linear_sparse(jnp.asarray(x), jdense_to_bsc(w, BLOCK),
                                jnp.asarray(b), relu=relu,
                                policy=_jpol(ConvMode.LOWERED_SPARSE))
    calls = bsc_spmm.calls
    out = linear.linear_sparse(torch.from_numpy(x), dense_to_bsc(w, BLOCK),
                               torch.from_numpy(b), relu=relu,
                               policy=ExecutionPolicy(use_xla_sparse=False))
    assert bsc_spmm.calls == calls + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    dense = linear.linear(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), relu=relu)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), **TOL)


def test_softmax_relu():
    x = np.random.default_rng(5).standard_normal((3, 24)).astype(np.float32)
    np.testing.assert_allclose(activations.softmax(torch.from_numpy(x)).numpy(),
                               np.asarray(jact.softmax(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        activations.relu(torch.from_numpy(x), 0.1).numpy(),
        np.asarray(jact.relu(jnp.asarray(x), 0.1)), **TOL)


def test_norm_and_eltwise():
    rng = np.random.default_rng(6)
    x, y = (rng.standard_normal((2, 3, 3, 8)).astype(np.float32)
            for _ in range(2))
    mean, gamma, beta = (rng.standard_normal(8).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        norm.batch_norm_inference(t(x), t(mean), t(var)).numpy(),
        np.asarray(jnorm.batch_norm_inference(x, mean, var)), **TOL)
    np.testing.assert_allclose(
        norm.scale_bias(t(x), t(gamma), t(beta)).numpy(),
        np.asarray(jnorm.scale_bias(x, gamma, beta)), **TOL)
    np.testing.assert_allclose(
        structural.eltwise([t(x), t(y)], coeffs=[1.0, -0.5]).numpy(),
        np.asarray(jstruct.eltwise([x, y], coeffs=[1.0, -0.5])), **TOL)
