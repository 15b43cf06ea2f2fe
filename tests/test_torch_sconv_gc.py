"""Port parity: the plain version of the garbage-column direct sparse conv
(caffe_escoin_tpu_torch.kernels.sconv_gc) against the JAX package's Pallas
kernel ``caffe_escoin_tpu/kernels/sconv_pallas.py`` in interpret mode.

The plain version shares the kernel route's slab and output slice, so these
cases hold the slab geometry that the CUDA kernel reads. Tolerance rtol
1e-4, atol 1e-5: both sides multiply in f32, and only the order of the sums
differs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_fused as jsconv_fused  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_pallas as jsconv_pallas  # noqa: E402
from caffe_escoin_tpu.ops.conv import conv2d_sconv as jconv2d_sconv  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import sconv_fused, sconv_gc  # noqa: E402
from caffe_escoin_tpu_torch.ops.conv import conv2d_sconv, conv_route  # noqa: E402
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def _policies(block):
    jpol = JPolicy(block_shape=block, interpret=True, use_pallas=True,
                   mxu_dtype="float32", use_xla_sparse=False,
                   conv_mode=JConvMode.SCONV_PAR, spmm_tile_m=64)
    return jpol, ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                                 block_shape=block, use_xla_sparse=False)


def _weights(n, h, w, cin, cout, k, sparsity, bias, seed, empty_col, block):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32) * 0.1
    wt = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05
    if empty_col:
        wt[..., block[1]:] = 0  # the second output block-column has no live block
    wp = prune_conv_weight(wt, sparsity, (min(block[0], cin), block[1]))
    b = rng.standard_normal(cout).astype(np.float32) * 0.1 if bias else None
    return x, wp, b


B128 = (128, 128)
CASES = {
    # name: (n, h, w, cin, cout, k, pad, sparsity, relu, bias, seed, empty,
    #        block)
    "3x3_pad1": (2, 10, 10, 128, 128, 3, 1, 0.75, False, False, 0, False,
                 B128),
    "5x5_pad2": (2, 12, 12, 96, 160, 5, 2, 0.8, False, False, 1, False, B128),
    "1x1": (2, 9, 9, 256, 128, 1, 0, 0.75, False, False, 2, False, B128),
    "multi_cin_block": (1, 9, 9, 256, 128, 3, 1, 0.7, False, False, 3,
                        False, B128),
    "multi_cin_block_b16": (2, 8, 8, 48, 32, 3, 1, 0.6, True, True, 4, False,
                            (16, 16)),
    "cin_pad_gt_cin": (2, 8, 8, 100, 64, 3, 1, 0.7, False, True, 5, False,
                       B128),
    "empty_block_column": (2, 8, 8, 128, 256, 3, 1, 0.5, True, True, 6, True,
                           B128),
    "cout_not_multiple_of_bn": (2, 9, 9, 128, 200, 3, 1, 0.6, True, True, 7,
                                False, B128),
    "bias_relu": (2, 10, 10, 128, 128, 3, 1, 0.9, True, True, 8, False,
                  B128),
    "odd_w_garbage_columns": (2, 9, 7, 64, 64, 3, 1, 0.6, True, True, 9,
                              False, B128),
    "no_pad_odd_w": (2, 9, 11, 64, 72, 3, 0, 0.6, False, True, 10, False,
                     B128),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas(name):
    n, h, w, cin, cout, k, pad, sp, relu, bias, seed, empty, block = \
        CASES[name]
    jpol, pol = _policies(block)
    x, wp, b = _weights(n, h, w, cin, cout, k, sp, bias, seed, empty, block)
    jal = jweight_align(wp, b, policy=jpol)
    assert jsconv_pallas.supported(jnp.asarray(x), jal, jpol)
    ref = jsconv_pallas.sconv(jnp.asarray(x), jal, padding=(pad, pad),
                              relu=relu, policy=jpol)
    al = weight_align(wp, b, policy=pol)
    xt = torch.from_numpy(x)
    assert sconv_gc.supported(xt, al) and sconv_gc.fits_budget(xt, al)
    if empty:
        assert int(al.bsc.bcol_nnz.min()) == 0
    if name == "cin_pad_gt_cin":
        assert al.cin_pad > al.cin
    if name.startswith("multi_cin_block"):
        assert al.cin_pad // al.bsc.block_shape[0] > 1
    calls, launches = sconv_gc.calls, sconv_gc.launches
    out = sconv_gc.sconv(xt, al, padding=(pad, pad), relu=relu)
    assert sconv_gc.calls == calls + 1
    assert sconv_gc.launches == launches  # CPU tensors: the plain route
    assert out.shape == tuple(ref.shape) and out.dtype == torch.float32
    assert out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("relu", [True, False])
def test_residual_through_gc_route_matches_jax(monkeypatch, relu):
    """With both fused budgets at 0, both dispatchers take the
    garbage-column kernel and add the residual after it."""
    monkeypatch.setattr(jsconv_fused, "VMEM_BUDGET", 0)
    monkeypatch.setattr(sconv_fused, "VMEM_BUDGET", 0)
    jpol, pol = _policies(B128)
    x, wp, b = _weights(2, 10, 9, 128, 256, 3, 0.75, True, 11, False, B128)
    res = np.random.default_rng(12).standard_normal(
        (2, 10, 9, 256)).astype(np.float32)
    jal = jweight_align(wp, b, policy=jpol)
    seen = []
    real = jsconv_pallas.sconv

    def spy(*a, **kw):
        seen.append("gc")
        return real(*a, **kw)

    monkeypatch.setattr(jsconv_pallas, "sconv", spy)
    ref = jconv2d_sconv(jnp.asarray(x), jal, stride=(1, 1), padding=(1, 1),
                        dilation=(1, 1), relu=relu, policy=jpol,
                        batch_parallel=True, residual=jnp.asarray(res))
    assert seen == ["gc"]
    al = weight_align(wp, b, policy=pol)
    xt = torch.from_numpy(x)
    assert conv_route(xt, al, padding=(1, 1), policy=pol) == "gc"
    calls = sconv_gc.calls
    out = conv2d_sconv(xt, al, stride=(1, 1), padding=(1, 1),
                       dilation=(1, 1), relu=relu, policy=pol,
                       residual=torch.from_numpy(res))
    assert sconv_gc.calls == calls + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_budget_counts_bytes_after_the_compute_cast():
    """VGG-16 conv2_2 at b16: its 114x114x128 slab is 3.3 MB in bf16 and
    6.7 MB in f32, on either side of the 6 MiB gate."""
    _, pol = _policies(B128)
    wp = prune_conv_weight(np.random.default_rng(0).standard_normal(
        (3, 3, 128, 128)).astype(np.float32), 0.9, B128)
    al = weight_align(wp, None, policy=pol)
    x16 = torch.empty((16, 112, 112, 128), dtype=torch.bfloat16,
                      device="meta")
    x32 = torch.empty((16, 112, 112, 128), dtype=torch.float32, device="meta")
    assert sconv_gc.fits_budget(x16, al) and not sconv_gc.fits_budget(x32, al)
    assert not sconv_fused.fits_budget(x16, al, (1, 1))
    assert conv_route(x16, al, padding=(1, 1), policy=pol) == "gc"
    assert conv_route(x32, al, padding=(1, 1), policy=pol) == "lowered"


def test_bf16_multiplies_round_operands():
    """mxu_dtype="bfloat16" (the card's multiply dtype) on the plain route:
    bf16-rounded operands, f32 sums, against an f32 oracle at bf16 scale."""
    _, pol = _policies(B128)
    x, wp, b = _weights(2, 12, 9, 128, 128, 3, 0.9, True, 13, False, B128)
    al = weight_align(wp, b, policy=pol)
    xt = torch.from_numpy(x)
    out = sconv_gc.sconv(xt.bfloat16(), al, padding=(1, 1), relu=False,
                         mxu_dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    ref = sconv_fused.sconv_plain(xt, al, padding=(1, 1), relu=False)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=0.05,
                               atol=0.02)
