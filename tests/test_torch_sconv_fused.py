"""Port parity: the plain version of the direct sparse conv kernel
(caffe_escoin_tpu_torch.kernels.sconv_fused) against the JAX package's
Pallas kernel in interpret mode, over that kernel's own test cases.

Tolerance rtol 1e-4, atol 1e-5 (the JAX test's own): both sides multiply
in f32, and only the order of the sums differs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_fused as jsconv  # noqa: E402
from caffe_escoin_tpu.ops.conv import conv2d_sconv as jconv2d_sconv  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import sconv_fused  # noqa: E402
from caffe_escoin_tpu_torch.ops.conv import conv2d_sconv  # noqa: E402
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight  # noqa: E402

JPOL = JPolicy(block_shape=(128, 128), interpret=True, use_pallas=True,
               mxu_dtype="float32", use_xla_sparse=False,
               conv_mode=JConvMode.SCONV_PAR)
POL = ExecutionPolicy(block_shape=(128, 128), use_xla_sparse=False)
TOL = dict(rtol=1e-4, atol=1e-5)


def _weights(n, h, w, cin, cout, k, sparsity, bias, seed, empty_col=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32) * 0.1
    wt = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05
    if empty_col:
        wt[..., 128:] = 0  # the second output block-column has no live block
    wp = prune_conv_weight(wt, sparsity, (min(128, cin), 128))
    b = rng.standard_normal(cout).astype(np.float32) * 0.1 if bias else None
    return x, wp, b


CASES = {
    # name: (n, h, w, cin, cout, k, pad, sparsity, relu, bias, seed, empty)
    "3x3_s0.5": (2, 14, 14, 256, 256, 3, 1, 0.5, False, False, 0, False),
    "3x3_s0.75": (2, 14, 14, 256, 256, 3, 1, 0.75, False, False, 0, False),
    "3x3_s0.9": (2, 14, 14, 256, 256, 3, 1, 0.9, False, False, 0, False),
    "3x3_s0.99": (2, 14, 14, 256, 256, 3, 1, 0.99, False, False, 0, False),
    "1x1": (2, 14, 14, 256, 512, 1, 0, 0.9, False, False, 0, False),
    "5x5_pad2": (2, 12, 12, 96, 160, 5, 2, 0.8, False, False, 0, False),
    "small_channels": (2, 28, 28, 64, 64, 3, 1, 0.85, False, False, 0, False),
    "bias_relu": (2, 10, 10, 128, 128, 3, 1, 0.9, True, True, 0, False),
    "unaligned_w7": (2, 7, 7, 128, 256, 3, 1, 0.9, False, False, 0, False),
    "multi_cin_block": (1, 9, 9, 256, 128, 3, 1, 0.7, False, False, 3, False),
    "empty_block_column": (2, 8, 8, 128, 256, 3, 1, 0.5, True, True, 4, True),
    "cout_not_multiple_of_bn": (2, 9, 9, 128, 200, 3, 1, 0.6, True, True, 5,
                                False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas(name):
    n, h, w, cin, cout, k, pad, sp, relu, bias, seed, empty = CASES[name]
    x, wp, b = _weights(n, h, w, cin, cout, k, sp, bias, seed, empty)
    jal = jweight_align(wp, b, policy=JPOL)
    assert jsconv.supported(jnp.asarray(x), jal, (pad, pad), JPOL)
    ref = jsconv.sconv(jnp.asarray(x), jal, padding=(pad, pad), relu=relu,
                       policy=JPOL)
    al = weight_align(wp, b, policy=POL)
    xt = torch.from_numpy(x)
    assert sconv_fused.supported(xt, al)
    if empty:
        assert int(al.bsc.bcol_nnz.min()) == 0
    calls, launches = sconv_fused.calls, sconv_fused.launches
    out = sconv_fused.sconv(xt, al, padding=(pad, pad), relu=relu)
    assert sconv_fused.calls == calls + 1
    assert sconv_fused.launches == launches  # CPU tensors: the plain route
    assert out.shape == tuple(ref.shape) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("stride,relu", [((1, 1), True), ((1, 1), False),
                                         ((2, 2), True)])
def test_residual_epilogue_matches_conv2d_sconv(stride, relu):
    """Residual (fused Eltwise) in the epilogue, against the JAX dispatcher's
    residual route; stride 2 goes through the 1x1 subsample."""
    rng = np.random.default_rng(7)
    k = 3 if stride == (1, 1) else 1
    pad = 1 if k == 3 else 0
    x, wp, b = _weights(2, 10, 10, 128, 256, k, 0.75, True, 7)
    ho = (10 + 2 * pad - k) // stride[0] + 1
    res = rng.standard_normal((2, ho, ho, 256)).astype(np.float32)
    jal = jweight_align(wp, b, policy=JPOL)
    ref = jconv2d_sconv(jnp.asarray(x), jal, stride=stride, padding=(pad, pad),
                        dilation=(1, 1), relu=relu, policy=JPOL,
                        batch_parallel=True, residual=jnp.asarray(res))
    al = weight_align(wp, b, policy=POL)
    calls = sconv_fused.calls
    out = conv2d_sconv(torch.from_numpy(x), al, stride=stride,
                       padding=(pad, pad), dilation=(1, 1), relu=relu,
                       policy=POL, residual=torch.from_numpy(res))
    assert sconv_fused.calls == calls + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bf16_multiplies_round_operands():
    """mxu_dtype="bfloat16" (the card's multiply dtype) on the plain route:
    bf16-rounded operands, f32 sums, against an f32 oracle at bf16 scale."""
    x, wp, b = _weights(2, 14, 14, 128, 128, 3, 0.9, True, 1)
    al = weight_align(wp, b, policy=POL)
    xt = torch.from_numpy(x)
    out = sconv_fused.sconv(xt.bfloat16(), al, padding=(1, 1), relu=False,
                            mxu_dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    ref = sconv_fused.sconv_plain(xt, al, padding=(1, 1), relu=False)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=0.05,
                               atol=0.02)
