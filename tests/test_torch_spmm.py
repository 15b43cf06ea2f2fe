"""Port parity for the unstructured-sparsity slice: the CSR, ELL and BSR
formats, the gather and block-row SpMMs (kernels/spmm.py), ``weight_align``
with the ELL artifact and the sparsity statistics, and the LOWERED_SPARSE
conv and the fc on an ELL, against the JAX package's functions on the same
numpy inputs.

Formats and alignment: bit-exact on every array. Products: f32 on both
sides, rtol = atol = 1e-5 for the SpMMs (sums in another order), 1e-4 /
1e-5 for the convs (the im2col GEMM sums over more terms), as
tests/test_torch_ops.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.engine.context import SparseFormat as JSparseFormat  # noqa: E402
from caffe_escoin_tpu.kernels import spmm as jspmm  # noqa: E402
from caffe_escoin_tpu.ops import conv as jconv  # noqa: E402
from caffe_escoin_tpu.ops import linear as jlinear  # noqa: E402
from caffe_escoin_tpu.sparse import formats as jformats  # noqa: E402
from caffe_escoin_tpu.sparse import weight_align as jwa  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import (ConvMode,  # noqa: E402
                                                   ExecutionPolicy,
                                                   SparseFormat)
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_fused  # noqa: E402
from caffe_escoin_tpu_torch.kernels import spmm  # noqa: E402
from caffe_escoin_tpu_torch.ops import conv, linear  # noqa: E402
from caffe_escoin_tpu_torch.sparse import formats  # noqa: E402
from caffe_escoin_tpu_torch.sparse import weight_align as wa  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,  # noqa: E402
                                                  prune_magnitude)

SPMM_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-5)


def _sparse(shape, sparsity, seed=0, empty_row=False):
    w = prune_magnitude(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32), sparsity)
    if empty_row:
        w[shape[0] // 2] = 0
    return w


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.numpy().dtype == np.asarray(j).dtype


# -- formats -----------------------------------------------------------------

@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9, 1.0])
def test_dense_to_csr_bit_exact(sparsity):
    w = _sparse((17, 23), sparsity, empty_row=True)
    t, j = formats.dense_to_csr(w), jformats.dense_to_csr(w)
    _eq(t.values, j.values)
    _eq(t.colidx, j.colidx)
    _eq(t.rowptr, j.rowptr)
    assert (t.shape, t.nnz, t.density) == (tuple(j.shape), j.nnz, j.density)
    np.testing.assert_array_equal(t.to_dense().numpy(), w)


ELL_CASES = {  # (shape, sparsity, width, lane_pad, empty row)
    "lane1": ((17, 40), 0.7, None, 1, False),
    "lane8": ((32, 64), 0.9, None, 8, False),
    "empty_row": ((12, 30), 0.5, None, 8, True),
    "explicit_width": ((10, 20), 0.8, 13, 8, False),
    "all_zero": ((6, 9), 1.0, None, 1, False),
}


@pytest.mark.parametrize("name", list(ELL_CASES))
def test_dense_to_ell_bit_exact(name):
    shape, sparsity, width, lane_pad, empty = ELL_CASES[name]
    w = _sparse(shape, sparsity, empty_row=empty)
    t = formats.dense_to_ell(w, width=width, lane_pad=lane_pad)
    j = jformats.dense_to_ell(w, width=width, lane_pad=lane_pad)
    _eq(t.values, j.values)
    _eq(t.colidx, j.colidx)
    _eq(t.row_nnz, j.row_nnz)
    assert (t.shape, t.width, t.nnz) == (tuple(j.shape), j.width, j.nnz)
    assert t.width % lane_pad == 0
    np.testing.assert_array_equal(t.to_dense().numpy(), w)


@pytest.mark.parametrize("shape,block,pad_to,sparsity", [
    ((32, 64), (8, 8), 1, 0.75),
    ((30, 41), (8, 16), 4, 0.5),  # ragged edges, max_bw rounded up
    ((16, 16), (8, 8), 1, 1.0),  # no live block: one zero flat slot
])
def test_dense_to_bsr_bit_exact(shape, block, pad_to, sparsity):
    w = prune_blocks(np.random.default_rng(1).standard_normal(shape).astype(
        np.float32), sparsity, block)
    t = formats.dense_to_bsr(w, block, pad_to=pad_to)
    j = jformats.dense_to_bsr(w, block, pad_to=pad_to)
    for name in ("blocks", "block_col", "brow_nnz", "flat_blocks",
                 "flat_row", "flat_col"):
        _eq(getattr(t, name), getattr(j, name))
    assert (t.shape, t.block_shape, t.n_brows, t.n_bcols, t.max_bw,
            t.n_flat, t.nnz_blocks, t.block_density) == (
        tuple(j.shape), tuple(j.block_shape), j.n_brows, j.n_bcols,
        j.max_bw, j.n_flat, j.nnz_blocks, j.block_density)
    np.testing.assert_array_equal(t.to_dense().numpy(), w)


def test_formats_to_casts_values_not_indices():
    w = _sparse((16, 24), 0.7)
    ell = formats.dense_to_ell(w, lane_pad=8).to(dtype=torch.bfloat16)
    assert ell.values.dtype == torch.bfloat16
    assert ell.colidx.dtype == ell.row_nnz.dtype == torch.int32
    assert ell.nnz == int((w != 0).sum())
    csr = formats.dense_to_csr(w).to(dtype=torch.bfloat16)
    assert csr.values.dtype == torch.bfloat16
    assert csr.colidx.dtype == csr.rowptr.dtype == torch.int32
    bsr = formats.dense_to_bsr(w, (8, 8)).to(dtype=torch.bfloat16)
    assert bsr.blocks.dtype == bsr.flat_blocks.dtype == torch.bfloat16
    assert bsr.block_col.dtype == bsr.flat_row.dtype == torch.int32


# -- SpMMs -------------------------------------------------------------------

@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("shape_n", [((32, 64), 16), ((17, 40), 8),
                                     ((128, 30), 64)])
def test_ell_spmm_matches_jax(shape_n, sparsity):
    (rows, k), n = shape_n
    w = _sparse((rows, k), sparsity, seed=rows)
    b = np.random.default_rng(2).standard_normal((k, n)).astype(np.float32)
    ref = jspmm.ell_spmm(jformats.dense_to_ell(w, lane_pad=8),
                         jnp.asarray(b))
    out = spmm.ell_spmm(formats.dense_to_ell(w, lane_pad=8),
                        torch.from_numpy(b))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SPMM_TOL)


def test_ell_spmm_in_steps_matches_one_step(monkeypatch):
    """The slots walked in steps of at most GATHER_BYTES of gathered rows
    (here 4 slots, with a ragged last step) give the one-step sum, and
    accept a transposed operand."""
    w = _sparse((24, 50), 0.6, seed=3)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (9, 50)).astype(np.float32)).T
    ell = formats.dense_to_ell(w)
    whole = spmm.ell_spmm(ell, b)
    monkeypatch.setattr(spmm, "GATHER_BYTES", 4 * 24 * 9 * 4)
    assert ell.width % 4 != 0
    np.testing.assert_allclose(spmm.ell_spmm(ell, b).numpy(), whole.numpy(),
                               **SPMM_TOL)
    np.testing.assert_allclose(whole.numpy(), w @ b.numpy(), **SPMM_TOL)


@pytest.mark.parametrize("block", [(8, 8), (8, 16)])
@pytest.mark.parametrize("sparsity", [0.0, 0.75, 1.0])
@pytest.mark.parametrize("shape", [(32, 64), (30, 41)])
def test_bsr_spmm_matches_jax(block, sparsity, shape):
    w = prune_blocks(np.random.default_rng(5).standard_normal(shape).astype(
        np.float32), sparsity, block)
    b = np.random.default_rng(6).standard_normal((shape[1], 24)).astype(
        np.float32)
    ref = jspmm.bsr_spmm(jformats.dense_to_bsr(w, block), jnp.asarray(b))
    out = spmm.bsr_spmm(formats.dense_to_bsr(w, block), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SPMM_TOL)


def test_spmm_dispatch():
    w = prune_blocks(_sparse((32, 48), 0.3), 0.5, (8, 8))
    b = np.random.default_rng(7).standard_normal((48, 5)).astype(np.float32)
    for tfmt, jfmt in ((formats.dense_to_ell(w), jformats.dense_to_ell(w)),
                       (formats.dense_to_bsr(w, (8, 8)),
                        jformats.dense_to_bsr(w, (8, 8)))):
        np.testing.assert_allclose(
            spmm.spmm(tfmt, torch.from_numpy(b)).numpy(),
            np.asarray(jspmm.spmm(jfmt, jnp.asarray(b))), **SPMM_TOL)
    with pytest.raises(TypeError):
        spmm.spmm(formats.dense_to_csr(w), torch.from_numpy(b))
    with pytest.raises(ValueError):
        spmm.ell_spmm(formats.dense_to_ell(w), torch.zeros(47, 5))


# -- weight_align with ELL and statistics -------------------------------------

@pytest.mark.parametrize("k,cin,groups,with_ell", [
    (3, 16, 1, None), (1, 40, 1, True), (3, 12, 3, None), (3, 16, 1, False),
    (5, 3, 1, None)])
def test_weight_align_ell_and_stats_match_jax(k, cin, groups, with_ell):
    rng = np.random.default_rng(k * 100 + cin)
    cout = 24
    w = prune_magnitude(rng.standard_normal(
        (k, k, cin // groups, cout)).astype(np.float32), 0.8)
    if cin == 3:  # a dense stem: below the threshold, no sparse artifact
        w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    jpol = JPolicy(block_shape=(8, 8), sparse_format=JSparseFormat.ELL)
    pol = ExecutionPolicy(block_shape=(8, 8), sparse_format=SparseFormat.ELL)
    t = wa.weight_align(w, groups=groups, policy=pol, with_ell=with_ell)
    j = jwa.weight_align(w, groups=groups, policy=jpol, with_ell=with_ell)
    assert (t.ell_t is None) == (j.ell_t is None)
    assert (t.ell_t is None) == (with_ell is False or cin == 3)
    if t.ell_t is not None:
        for name in ("values", "colidx", "row_nnz"):
            _eq(getattr(t.ell_t, name), getattr(j.ell_t, name))
        assert t.ell_t.shape == tuple(j.ell_t.shape) == (cout, t.k)
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.stats.nnz == int((w != 0).sum())


def test_weight_align_without_stats_and_default_format():
    w = prune_magnitude(np.random.default_rng(8).standard_normal(
        (3, 3, 16, 16)).astype(np.float32), 0.8)
    t = wa.weight_align(w, policy=ExecutionPolicy(block_shape=(8, 8)),
                        with_stats=False)
    assert t.stats is None and t.ell_t is None and t.bsc is not None
    ell = wa.weight_align(w, policy=ExecutionPolicy(
        block_shape=(8, 8), sparse_format=SparseFormat.ELL)).to(
        dtype=torch.bfloat16)
    assert ell.ell_t.values.dtype == torch.bfloat16
    assert ell.ell_t.colidx.dtype == torch.int32


# -- the LOWERED_SPARSE conv and the fc on an ELL ------------------------------

# (kernel, stride, pad, groups, relu, residual)
ELL_CONV_CASES = {
    "3x3_s1_p1": (3, 1, 1, 1, False, False),
    "3x3_s2_p1": (3, 2, 1, 1, True, False),
    "1x1": (1, 1, 0, 1, False, False),
    "3x3_grouped": (3, 1, 1, 4, False, False),
    "3x3_residual_relu": (3, 1, 1, 1, True, True),
    "1x1_s2_residual_relu": (1, 2, 0, 1, True, True),
}


@pytest.mark.parametrize("name", list(ELL_CONV_CASES))
def test_conv2d_lowered_ell_matches_jax(name):
    k, s, p, groups, relu, with_res = ELL_CONV_CASES[name]
    rng = np.random.default_rng(13)
    cin, cout, hw = 32, 48, 9
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = prune_magnitude(rng.standard_normal(
        (k, k, cin // groups, cout)).astype(np.float32) * 0.1, 0.9)
    b = rng.standard_normal(cout).astype(np.float32)
    ho = (hw + 2 * p - k) // s + 1
    res = rng.standard_normal((2, ho, ho, cout)).astype(np.float32) \
        if with_res else None
    jpol = JPolicy(conv_mode=JConvMode.LOWERED_SPARSE, block_shape=(8, 8),
                   sparse_format=JSparseFormat.ELL)
    ref = jconv.conv2d(jnp.asarray(x), jwa.weight_align(
        w, b, groups=groups, policy=jpol), stride=(s, s), padding=(p, p),
        relu=relu, policy=jpol,
        residual=None if res is None else jnp.asarray(res))
    pol = ExecutionPolicy(conv_mode=ConvMode.LOWERED_SPARSE,
                          block_shape=(8, 8), sparse_format=SparseFormat.ELL)
    al = wa.weight_align(w, b, groups=groups, policy=pol)
    xt = torch.from_numpy(x)
    assert conv.conv_route(xt, al, stride=(s, s), padding=(p, p),
                           policy=pol) == "ell"
    calls = (sconv_fused.calls, bsc_spmm.calls)
    out = conv.conv2d(xt, al, stride=(s, s), padding=(p, p), relu=relu,
                      policy=pol,
                      residual=None if res is None else torch.from_numpy(res))
    assert (sconv_fused.calls, bsc_spmm.calls) == calls  # no kernel entry
    assert out.dtype == torch.float32 and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)


def test_conv2d_ell_route_needs_the_artifact_and_the_format():
    w = prune_magnitude(np.random.default_rng(14).standard_normal(
        (3, 3, 16, 16)).astype(np.float32), 0.9)
    x = torch.empty((1, 8, 8, 16), device="meta")
    bsr_pol = ExecutionPolicy(conv_mode=ConvMode.LOWERED_SPARSE,
                              block_shape=(8, 8))
    ell_pol = ExecutionPolicy(conv_mode=ConvMode.LOWERED_SPARSE,
                              block_shape=(8, 8),
                              sparse_format=SparseFormat.ELL)
    no_ell = wa.weight_align(w, policy=bsr_pol)
    with_ell = wa.weight_align(w, policy=ell_pol)
    assert conv.conv_route(x, no_ell, padding=(1, 1),
                           policy=ell_pol) == "xbsp_lowered"
    assert conv.conv_route(x, with_ell, padding=(1, 1),
                           policy=bsr_pol) == "xbsp_lowered"
    assert conv.conv_route(x, with_ell, padding=(1, 1),
                           policy=ell_pol) == "ell"
    # a weight below the threshold has no sparse artifact: dense
    dense = wa.weight_align(np.ones((3, 3, 16, 16), np.float32),
                            policy=ell_pol)
    assert dense.ell_t is None and dense.bsc is None
    assert conv.conv_route(x, dense, padding=(1, 1), policy=ell_pol) == "dense"


@pytest.mark.parametrize("relu", [False, True])
def test_linear_sparse_on_an_ell(relu):
    rng = np.random.default_rng(15)
    w = prune_magnitude(rng.standard_normal((64, 40)).astype(np.float32), 0.9)
    b = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    ref = jlinear.linear_sparse(jnp.asarray(x), jformats.dense_to_ell(w.T),
                                jnp.asarray(b), relu=relu)
    calls = bsc_spmm.calls
    out = linear.linear_sparse(torch.from_numpy(x),
                               formats.dense_to_ell(w.T, lane_pad=8),
                               torch.from_numpy(b), relu=relu)
    assert bsc_spmm.calls == calls
    assert out.shape == (2, 3, 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)
