"""Port parity: the XBSP arms (caffe_escoin_tpu_torch.kernels.
xla_block_sparse) against the JAX package's ``kernels/xla_block_sparse.py``
on the CPU, over the same numpy inputs.

Tolerances: f32 on both sides (TF32 plays no part on the CPU), max|err| <=
1e-5 * max|ref| (the same products, summed in another order); bf16 inputs
with f32 accumulation on both sides, max|err| <= 1e-2 * max|ref| + 1e-2
(the bf16 output's rounding), the rule of the port's kernel tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import xla_block_sparse as jxbs  # noqa: E402
from caffe_escoin_tpu.sparse import dense_to_bsc as jdense_to_bsc  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs  # noqa: E402
from caffe_escoin_tpu_torch.ops import conv as conv_ops  # noqa: E402
from caffe_escoin_tpu_torch.sparse import dense_to_bsc  # noqa: E402
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,  # noqa: E402
                                                  prune_conv_weight)

ARMS = {"conv": (xbs.conv, jxbs.conv),
        "conv_gathered": (xbs.conv_gathered, jxbs.conv_gathered),
        "conv_gathered_cols": (xbs.conv_gathered_cols,
                               jxbs.conv_gathered_cols)}

# name: (n, h, w, cin, cout, k, stride, pad, dilation, sparsity, block,
#        bias, relu, residual, empty last block-column)
CASES = {
    "3x3_s0.5": (2, 9, 9, 32, 32, 3, 1, 1, 1, 0.5, (16, 16), False, False,
                 False, False),
    "3x3_s0.9": (2, 9, 9, 32, 32, 3, 1, 1, 1, 0.9, (16, 16), False, False,
                 False, False),
    "3x3_s0.99": (2, 9, 9, 64, 64, 3, 1, 1, 1, 0.99, (16, 16), False, False,
                  False, False),
    "1x1_expand": (2, 7, 7, 32, 64, 1, 1, 0, 1, 0.8, (16, 16), True, False,
                   False, False),
    "1x1_full_union": (2, 6, 6, 16, 48, 1, 1, 0, 1, 0.5, (16, 16), False,
                       False, False, False),
    "stride2": (2, 9, 8, 32, 32, 3, 2, 1, 1, 0.8, (16, 16), True, False,
                False, False),
    "dilation2": (1, 11, 11, 32, 32, 3, 1, 2, 2, 0.8, (16, 16), False, True,
                  False, False),
    "5x5": (1, 10, 10, 16, 32, 5, 1, 2, 1, 0.8, (16, 16), True, False, False,
            False),
    "channel_tail": (1, 8, 7, 26, 18, 3, 1, 1, 1, 0.7, (8, 8), True, True,
                     False, False),
    "bias_relu_residual": (2, 8, 8, 32, 48, 3, 1, 1, 1, 0.75, (16, 16), True,
                           True, True, False),
    "empty_block_column": (2, 7, 7, 32, 48, 3, 1, 1, 1, 0.6, (16, 16), True,
                           True, True, True),
}


def _case(name, seed=0):
    (n, h, w, cin, cout, k, s, p, d, sp, block, bias, relu, res,
     empty) = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.1
    wp = prune_conv_weight(wt, sp, (min(block[0], cin), block[1]))
    if empty:
        wp[..., (cout - 1) // block[1] * block[1]:] = 0
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    ho = (h + 2 * p - d * (k - 1) - 1) // s + 1
    wo = (w + 2 * p - d * (k - 1) - 1) // s + 1
    r = (rng.standard_normal((n, ho, wo, cout)).astype(np.float32)
         if res else None)
    al = weight_align(wp, b, policy=ExecutionPolicy(block_shape=block))
    jal = jweight_align(wp, b, policy=JPolicy(block_shape=block))
    if empty:
        assert al.bsc.pattern()[1][-1] == 0
    geo = dict(stride=(s, s), padding=(p, p), dilation=(d, d), relu=relu)
    return x, r, al, jal, geo


def _check(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    scale = np.abs(ref).max()
    bound = 1e-5 * scale if dtype == "f32" else 1e-2 * scale + 1e-2
    assert np.abs(out - ref).max() <= bound, (np.abs(out - ref).max(), bound)


def _run(arm, name, dtype, monkeypatch=None, nopad=False):
    x, r, al, jal, geo = _case(name)
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    if monkeypatch is not None:
        if nopad:
            monkeypatch.setenv("CESCOIN_XBSP_NOPAD", "1")
        else:
            monkeypatch.delenv("CESCOIN_XBSP_NOPAD", raising=False)
    fn, jfn = ARMS[arm]
    ref = jfn(jnp.asarray(x).astype(jdt), jal,
              residual=None if r is None else jnp.asarray(r).astype(jdt),
              **geo)
    out = fn(torch.from_numpy(x).to(tdt), al,
             residual=None if r is None else torch.from_numpy(r).to(tdt),
             **geo)
    assert out.dtype == tdt
    _check(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("arm", list(ARMS))
def test_arm_matches_jax(arm, name, dtype, monkeypatch):
    _run(arm, name, dtype, monkeypatch)


@pytest.mark.parametrize("name", ["3x3_s0.9", "stride2", "dilation2", "5x5",
                                  "channel_tail", "bias_relu_residual"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_nopad_form_matches_jax(arm, name, monkeypatch):
    """CESCOIN_XBSP_NOPAD=1 on both sides: the pad-free valid-slice form."""
    _run(arm, name, "f32", monkeypatch, nopad=True)


def test_nopad_halo_only_offset_matches_padded(monkeypatch):
    """An offset that reads only halo (k=5, pad 2 on a 2-wide map) adds
    nothing in the pad-free form, as the padded form's zeros do."""
    rng = np.random.default_rng(3)
    wt = rng.standard_normal((5, 5, 16, 16)).astype(np.float32)
    al = weight_align(wt, policy=ExecutionPolicy(block_shape=(16, 16),
                                                 sconv_threshold=0.0,
                                                 sparse_threshold=0.0))
    x = torch.from_numpy(rng.standard_normal((1, 2, 2, 16)).astype(
        np.float32))
    for fn in (xbs.conv, xbs.conv_gathered, xbs.conv_gathered_cols):
        monkeypatch.delenv("CESCOIN_XBSP_NOPAD", raising=False)
        padded = fn(x, al, padding=(2, 2))
        monkeypatch.setenv("CESCOIN_XBSP_NOPAD", "1")
        np.testing.assert_allclose(fn(x, al, padding=(2, 2)).numpy(),
                                   padded.numpy(), rtol=1e-5, atol=1e-5)


# (m, k, n, block, sparsity, bias, relu, x carries the padded K)
SPMM_CASES = {
    "k_tail": (10, 200, 96, (16, 16), 0.7, True, True, False),
    "k_padded": (10, 200, 96, (16, 16), 0.7, True, False, True),
    "n_tail_no_bias": (7, 64, 40, (8, 16), 0.8, False, False, False),
    "fc_like": (4, 512, 256, (128, 128), 0.9, True, False, False),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(SPMM_CASES))
def test_spmm_matches_jax(name, dtype):
    m, k, n, block, sp, bias, relu, padded = SPMM_CASES[name]
    rng = np.random.default_rng(4)
    w = prune_blocks(rng.standard_normal((k, n)).astype(np.float32), sp, block)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if padded:
        x = np.pad(x, ((0, 0), (0, -k % block[0])))
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    ref = jxbs.spmm(jnp.asarray(x).astype(jdt), jdense_to_bsc(w, block),
                    bias=None if b is None else jnp.asarray(b), relu=relu)
    out = xbs.spmm(torch.from_numpy(x).to(tdt), dense_to_bsc(w, block),
                   bias=None if b is None else torch.from_numpy(b), relu=relu)
    assert out.dtype == tdt
    _check(out, ref, dtype)


@pytest.mark.parametrize("sparsity", [0.3, 0.6, 0.9, 0.99])
@pytest.mark.parametrize("k,cin,cout", [(3, 64, 64), (1, 256, 128),
                                        (1, 128, 512), (1, 256, 512)])
def test_union_live_fraction_matches_jax(k, cin, cout, sparsity):
    rng = np.random.default_rng(5)
    wp = prune_conv_weight(rng.standard_normal((k, k, cin, cout)).astype(
        np.float32), sparsity, (128, 128))
    thr = dict(block_shape=(128, 128), sparse_threshold=0.0,
               sconv_threshold=0.0)
    al = weight_align(wp, policy=ExecutionPolicy(**thr))
    jal = jweight_align(wp, policy=JPolicy(**thr))
    assert xbs.union_live_fraction(al) == jxbs.union_live_fraction(jal)


@pytest.mark.parametrize("arm", ["auto", "unroll", "gathered",
                                 "gathered_cols", "dense", "fused"])
@pytest.mark.parametrize("sparsity", [None, 0.3, 0.6, 0.8, 0.95])
def test_best_arm_matches_jax(sparsity, arm):
    """Over kernel x cin/cout, at block densities above 0.5 (the first
    gate), in [0.25, 0.5] (the heuristic floor), below (the shape rules),
    and unstructured (None: every block live); forced arms win over all."""
    rng = np.random.default_rng(6)
    pol = ExecutionPolicy(block_shape=(128, 128), xbsp_arm=arm)
    jpol = JPolicy(block_shape=(128, 128), xbsp_arm=arm)
    seen = set()
    for k, cin, cout in [(3, 64, 64), (3, 256, 256), (1, 512, 128),
                         (1, 64, 256), (1, 128, 512), (1, 256, 512),
                         (1, 1024, 2048)]:
        w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
        wp = prune_conv_weight(w, 0.9 if sparsity is None else sparsity,
                               None if sparsity is None else (128, 128))
        al = weight_align(wp, policy=pol)
        jal = jweight_align(wp, policy=jpol)
        got = conv_ops.best_arm(al, pol)
        assert got == jxbs.best_arm(jal, jpol), (k, cin, cout)
        seen.add(got)
    if arm != "auto":
        assert seen == {arm}
    elif sparsity in (None, 0.3, 0.6):
        assert seen == {"dense"}
    elif sparsity == 0.95:
        assert {"unroll", "gathered", "dense"} <= seen


def test_host_pattern_travels_with_the_weight():
    """BSC keeps its pattern on the host through ``to`` (the arms never
    read the device tensors for it), and a copy starts an empty memo."""
    rng = np.random.default_rng(7)
    wp = prune_conv_weight(rng.standard_normal((3, 3, 32, 32)).astype(
        np.float32), 0.8, (16, 16))
    al = weight_align(wp, policy=ExecutionPolicy(block_shape=(16, 16)))
    xbs.conv(torch.zeros((1, 4, 4, 32)), al, padding=(1, 1))
    assert al.bsc.memo
    moved = al.to(dtype=torch.bfloat16)
    assert moved.bsc.block_row_np is al.bsc.block_row_np
    assert moved.bsc.memo == {}
    rows, nnz = moved.bsc.pattern()
    np.testing.assert_array_equal(rows, al.bsc.block_row.numpy())
    np.testing.assert_array_equal(nnz, al.bsc.bcol_nnz.numpy())
    bare = dataclasses.replace(al.bsc, block_row_np=None, bcol_nnz_np=None)
    np.testing.assert_array_equal(bare.pattern()[0], rows)


def test_union_weight_is_built_once():
    """The union-packed weight is memoised per weight object and dtype, and
    holds each live block where the gathered GEMM reads it."""
    rng = np.random.default_rng(8)
    wp = prune_conv_weight(rng.standard_normal((1, 1, 64, 96)).astype(
        np.float32), 0.6, (16, 16))
    al = weight_align(wp, policy=ExecutionPolicy(block_shape=(16, 16)))
    w1 = xbs._union_weight(al.bsc, torch.float32)
    assert xbs._union_weight(al.bsc, torch.float32) is w1
    union = xbs._union(al.bsc)
    dense = al.bsc.to_dense()
    rows = torch.cat([dense[kb * 16:(kb + 1) * 16] for kb in union])
    np.testing.assert_array_equal(w1[:, :96].numpy(), rows.numpy())
