"""Port parity for the oracles (caffe_escoin_tpu_torch/kernels/reference.py)
against the JAX package's (caffe_escoin_tpu/kernels/reference.py) on the
same numpy inputs: f32 on both sides, rtol 1e-5, atol 1e-5 (sums in another
order); the im2col copy and max pooling are exact."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.kernels import reference as jref  # noqa: E402

from caffe_escoin_tpu_torch.kernels import reference  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# (kernel, stride, padding, dilation, groups, bias, relu)
CONV_CASES = {
    "3x3_s1_p1": ((3, 3), (1, 1), (1, 1), (1, 1), 1, True, False),
    "3x3_s2_p1_relu": ((3, 3), (2, 2), (1, 1), (1, 1), 1, True, True),
    "1x1": ((1, 1), (1, 1), (0, 0), (1, 1), 1, False, False),
    "3x2_dilated": ((3, 2), (1, 2), (2, 1), (2, 2), 1, True, False),
    "3x3_grouped": ((3, 3), (1, 1), (1, 1), (1, 1), 4, True, True),
}


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_conv2d_reference_matches_jax(name):
    kernel, stride, padding, dilation, groups, bias, relu = CONV_CASES[name]
    rng = np.random.default_rng(0)
    cin, cout = 16, 24
    x = rng.standard_normal((2, 9, 10, cin)).astype(np.float32)
    w = rng.standard_normal(kernel + (cin // groups, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, relu=relu)
    ref = np.asarray(jref.conv2d_reference(x, w, b, **kw))
    out = reference.conv2d_reference(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), **kw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_conv2d_reference_rejects_a_group_mismatch():
    with pytest.raises(ValueError):
        reference.conv2d_reference(torch.zeros(1, 4, 4, 6),
                                   torch.zeros(3, 3, 4, 8), groups=2)


def test_spmm_reference_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((17, 40)).astype(np.float32)
    w[np.abs(w) < 1] = 0
    b = rng.standard_normal((40, 9)).astype(np.float32)
    np.testing.assert_allclose(
        reference.spmm_reference(torch.from_numpy(w),
                                 torch.from_numpy(b)).numpy(),
        np.asarray(jref.spmm_reference(w, b)), **TOL)


@pytest.mark.parametrize("kernel,stride,padding,dilation", [
    ((3, 3), (1, 1), (1, 1), (1, 1)),
    ((3, 2), (2, 1), (1, 2), (1, 2)),
    ((1, 1), (2, 2), (0, 0), (1, 1)),
])
def test_im2col_reference_matches_jax(kernel, stride, padding, dilation):
    x = np.random.default_rng(2).standard_normal((2, 7, 6, 5)).astype(
        np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    np.testing.assert_array_equal(
        reference.im2col_reference(torch.from_numpy(x), kernel, **kw).numpy(),
        np.asarray(jref.im2col_reference(x, kernel, **kw)))


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3), (2, 2), (1, 1)),
    ((2, 2), None, (0, 0)),
    ((3, 2), (1, 2), (1, 0)),
])
def test_pool2d_reference_matches_jax(mode, kernel, stride, padding):
    """Both size with floor, so no window runs past the padded input."""
    x = np.random.default_rng(3).standard_normal((2, 9, 8, 4)).astype(
        np.float32)
    kw = dict(stride=stride, padding=padding, mode=mode)
    np.testing.assert_allclose(
        reference.pool2d_reference(torch.from_numpy(x), kernel, **kw).numpy(),
        np.asarray(jref.pool2d_reference(x, kernel, **kw)), **TOL)
