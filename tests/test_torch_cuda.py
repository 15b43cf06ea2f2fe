"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device and run on the machine with
the card, which has no jax, so without tests/conftest.py (it imports jax):
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``. The
first launch builds the kernels with nvcc (kernels/_build.py).

Tolerance: max |kernel - plain| <= 1e-2 * max|plain| + 1e-2 in bf16 (the
output's bf16 rounding and another order of the f32 sums; the plain version
rounds the operands to bf16 as the kernel does), 2e-3 relative for f32
activations (operands are still multiplied in bf16 on both sides).

The direct-conv cases cover the edges of the pipelined tile loop
(csrc/sconv_pipe.cuh): an empty block-column (bias, residual and ReLU
only), more live K steps than ring stages, the M tail, the Cout tail with
bn = 32, 64 and 128, a Cout that is not a multiple of 8 (the epilogue's
scalar stores), bk = 16 with a Cin tail, Cin and bk that are not multiples
of 8 (the wrapper pads them), 128-row tiles, and sconv_gc over several
images of odd width, whose epilogue writes the exact output.
"""

import numpy as np
import pytest
import torch

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import (_build, bsc_spmm, sconv_fused,
                                            sconv_gc)
from caffe_escoin_tpu_torch.sparse import dense_to_bsc
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
from caffe_escoin_tpu_torch.utils.pruning import prune_blocks, prune_conv_weight

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _weight(rng, k, cin, cout, sp, block, empty_bcol, dev):
    """A pruned conv weight aligned to BSC on ``dev``; ``empty_bcol`` zeroes
    its last block-column, so the BSC has a column with no live block."""
    wt = prune_conv_weight(
        rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05, sp,
        (min(block[0], cin), block[1]))
    if empty_bcol:
        wt[..., (cout - 1) // block[1] * block[1]:] = 0
    b = rng.standard_normal(cout).astype(np.float32)
    al = weight_align(wt, b, policy=ExecutionPolicy(block_shape=block))
    if empty_bcol:
        assert int(al.bsc.bcol_nnz[-1]) == 0
    return al.to(dev, torch.bfloat16)


def _close(out, ref, dtype):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    bound = (1e-2 * scale + 1e-2) if dtype == torch.bfloat16 else 2e-3 * scale
    assert torch.isfinite(out).all()
    assert err <= bound, (err, bound)


# (n, h, w, cin, cout, k, pad, sparsity, relu, residual, block, empty_bcol)
SCONV_SHAPES = {
    "3x3_c64_res_relu": (2, 14, 14, 64, 64, 3, 1, 0.85, True, True,
                         (128, 128), False),
    "1x1_c256_to_200_bn128": (2, 7, 7, 256, 200, 1, 0, 0.75, False, False,
                              (128, 128), False),
    "3x3_c40_pad_tail_b16": (1, 9, 11, 40, 24, 3, 1, 0.7, True, False,
                             (16, 16), False),
    "1x1_c256_to_256_empty_bcol_res": (2, 9, 9, 256, 256, 1, 0, 0.25, True,
                                       True, (128, 128), True),
    "3x3_c256_steps_gt_stages_res": (2, 8, 8, 256, 256, 3, 1, 0.5, True,
                                     True, (128, 128), False),
    "1x1_c128_to_200_bn32": (2, 7, 7, 128, 200, 1, 0, 0.6, False, True,
                             (128, 32), False),
    "3x3_c64_to_200_bn64": (1, 10, 9, 64, 200, 3, 1, 0.7, True, False,
                            (64, 64), False),
    "3x3_c30_cin_tail": (2, 6, 7, 30, 40, 3, 1, 0.6, True, True,
                         (128, 128), False),
    "3x3_c30_bk12": (1, 7, 6, 30, 32, 3, 1, 0.8, True, False, (12, 16),
                     False),
    "3x3_c64_tile128_res": (4, 96, 96, 64, 64, 3, 1, 0.85, True, True,
                            (128, 128), False),
    "3x3_c64_to_36_scalar_epilogue_res": (2, 6, 5, 64, 36, 3, 1, 0.7, True,
                                          True, (128, 128), False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(SCONV_SHAPES))
def test_sconv_kernel_matches_plain(dev, name, dtype):
    n, h, w, cin, cout, k, pad, sp, relu, with_res, block, empty = \
        SCONV_SHAPES[name]
    rng = np.random.default_rng(0)
    al = _weight(rng, k, cin, cout, sp, block, empty, dev)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(
        np.float32)).to(dev, dtype)
    res = torch.randn((n, h, w, cout), device=dev).to(dtype) \
        if with_res else None
    launches = sconv_fused.launches
    out = sconv_fused.sconv(x, al, padding=(pad, pad), relu=relu, residual=res)
    torch.cuda.synchronize()
    assert sconv_fused.launches == launches + 1
    assert out.dtype == dtype and out.shape == (n, h, w, cout)
    ref = sconv_fused.sconv_plain(x, al, padding=(pad, pad), relu=relu,
                                  residual=res, mxu_dtype="bfloat16")
    _close(out, ref, dtype)


# (n, h, w, cin, cout, k, pad, sparsity, relu, block, empty_bcol)
GC_SHAPES = {
    "3x3_c128_relu_odd_w": (2, 12, 9, 128, 128, 3, 1, 0.85, True, (128, 128),
                            False),
    "1x1_c256_to_200": (2, 7, 7, 256, 200, 1, 0, 0.75, False, (128, 128),
                        False),
    "3x3_c40_pad_tail_b16": (1, 9, 11, 40, 24, 3, 1, 0.7, True, (16, 16),
                             False),
    "5x5_c64_tiles_straddle_images": (3, 20, 17, 64, 64, 5, 2, 0.8, False,
                                      (128, 128), False),
    "3x3_c128_five_images_odd_w": (5, 10, 13, 128, 128, 3, 1, 0.8, True,
                                   (128, 128), False),
    "3x3_c128_to_256_empty_bcol": (2, 9, 7, 128, 256, 3, 1, 0.6, True,
                                   (128, 128), True),
    "3x3_c256_steps_gt_stages": (2, 8, 9, 256, 256, 3, 1, 0.5, True,
                                 (128, 128), False),
    "1x1_c128_to_200_bn32": (3, 7, 5, 128, 200, 1, 0, 0.6, False, (128, 32),
                             False),
    "3x3_c30_bk12": (2, 7, 9, 30, 32, 3, 1, 0.8, True, (12, 16), False),
    "3x3_c64_tile128": (4, 96, 96, 64, 64, 3, 1, 0.85, True, (128, 128),
                        False),
    "3x3_c64_to_36_scalar_epilogue": (2, 6, 5, 64, 36, 3, 1, 0.7, True,
                                      (128, 128), False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(GC_SHAPES))
def test_sconv_gc_kernel_matches_plain(dev, name, dtype):
    n, h, w, cin, cout, k, pad, sp, relu, block, empty = GC_SHAPES[name]
    rng = np.random.default_rng(2)
    al = _weight(rng, k, cin, cout, sp, block, empty, dev)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(
        np.float32)).to(dev, dtype)
    launches = sconv_gc.launches
    out = sconv_gc.sconv(x, al, padding=(pad, pad), relu=relu)
    torch.cuda.synchronize()
    assert sconv_gc.launches == launches + 1
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    assert out.dtype == dtype and out.shape == (n, ho, wo, cout)
    ref = sconv_gc.sconv_plain(x, al, padding=(pad, pad), relu=relu,
                               mxu_dtype="bfloat16")
    _close(out, ref, dtype)


def test_sconv_gc_raises_on_what_the_kernel_does_not_take(dev):
    wt = np.ones((3, 3, 16, 256), np.float32)
    wt[:, :, :, 128:] = 0
    al = weight_align(wt, policy=ExecutionPolicy(block_shape=(16, 256))).to(
        dev, torch.bfloat16)  # bn = 256: wider than the epilogue tiles
    x = torch.ones((1, 6, 6, 16), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        sconv_gc.sconv(x, al, padding=(1, 1), relu=False)
    with pytest.raises(NotImplementedError):
        sconv_gc.sconv(x, al, padding=(1, 1), relu=False, mxu_dtype="float32")


# (m, k, n, block, sparsity, relu, empty_bcol)
SPMM_SHAPES = {
    "fc1000": (32, 2048, 1000, (128, 128), 0.9, False, False),
    "ragged_k_tail_relu": (300, 200, 72, (64, 64), 0.5, True, False),
    "fc6_like_split_long_column": (16, 5120, 512, (128, 128), 0.5, True,
                                   False),
    "split_empty_bcol_bias_relu": (16, 1024, 384, (128, 128), 0.5, True,
                                   True),
    "unsplit_empty_bcol_bias_relu": (9000, 512, 384, (128, 128), 0.5, True,
                                     True),
    "k_not_multiple_of_8": (40, 203, 72, (64, 64), 0.4, True, False),
    "bk_12_not_multiple_of_8": (24, 100, 48, (12, 16), 0.5, False, False),
    "bn8": (20, 256, 40, (32, 8), 0.6, True, False),
    "bn32": (50, 512, 100, (64, 32), 0.7, False, False),
    "bn64_split": (8, 1024, 200, (64, 64), 0.6, True, False),
    "unsplit_large_m_300_tiles": (38400, 1024, 256, (128, 128), 0.5, True,
                                  False),
}


def _spmm_case(name, dev, dtype, seed=1):
    m, k, n, block, sp, relu, empty = SPMM_SHAPES[name]
    rng = np.random.default_rng(seed)
    w = prune_blocks(rng.standard_normal((k, n)).astype(np.float32), sp, block)
    if empty:
        w[:, (n - 1) // block[1] * block[1]:] = 0
    bsc = dense_to_bsc(w, block).to(dev, torch.bfloat16)
    if empty:
        assert int(bsc.bcol_nnz[-1]) == 0
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev, dtype)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    return a, bsc, bias, relu


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(SPMM_SHAPES))
def test_bsc_spmm_kernel_matches_plain(dev, name, dtype):
    a, bsc, bias, relu = _spmm_case(name, dev, dtype)
    launches = bsc_spmm.launches
    out = bsc_spmm.bsc_spmm(a, bsc, bias=bias, relu=relu)
    torch.cuda.synchronize()
    assert bsc_spmm.launches == launches + 1
    assert out.dtype == dtype and out.shape == (a.shape[0], bsc.shape[1])
    ref = bsc_spmm.bsc_spmm_plain(a, bsc, bias=bias, relu=relu,
                                  mxu_dtype="bfloat16")
    _close(out, ref, dtype)


def test_bsc_spmm_cases_take_the_paths_they_name(dev):
    """The "split" cases split K, the "unsplit" ones do not."""
    for name, (m, *_) in SPMM_SHAPES.items():
        p = bsc_spmm.launch_plan(m, _spmm_case(name, dev, torch.bfloat16)[1])
        if name.startswith("unsplit"):
            assert p.split == 1, (name, p)
        elif "split" in name:
            assert p.split > 1, (name, p)
        if "300_tiles" in name:
            assert p.m_tiles >= 300, (name, p)


def test_bsc_spmm_split_is_deterministic_and_leaves_counters_at_zero(dev):
    """A split launch gives the same bits in two eager calls and in a
    CUDA-graph replay, and leaves every counter at zero."""
    a, bsc, bias, relu = _spmm_case("fc6_like_split_long_column", dev,
                                    torch.bfloat16)
    assert bsc_spmm.launch_plan(a.shape[0], bsc).split > 1

    def run():
        return bsc_spmm.bsc_spmm(a, bsc, bias=bias, relu=relu)

    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, first)
    assert not bsc_spmm._counters[dev.index].any()
    assert torch.equal(run(), first)


def test_bsc_spmm_refuses_a_plan_the_kernel_does_not_match(dev):
    """The C entry checks the plan it is handed against the compiled kernel:
    wrong shared bytes, a split with 128-row tiles, shares that do not
    cover the longest column, or a missing workspace are refused."""
    a, bsc, bias, relu = _spmm_case("fc6_like_split_long_column", dev,
                                    torch.bfloat16)
    m, k = a.shape
    bk, bn = bsc.block_shape
    plan, dims = bsc_spmm._launch(m, k, bsc.shape[1], bk, bn, bsc.n_bcols,
                                  bsc.max_bw, int(relu), 1)
    assert plan.split > 1
    ws = torch.empty((plan.split, m, bsc.n_bcols * bn), device=dev)
    counters = bsc_spmm._counter_buffer(dev)
    out = torch.empty((m, bsc.shape[1]), dtype=a.dtype, device=dev)
    lib = _build.load()

    def call(d, ws_ptr=ws.data_ptr()):
        return lib.cet_bsc_spmm(
            a.data_ptr(), bsc.blocks.data_ptr(), bsc.block_row.data_ptr(),
            bsc.bcol_nnz.data_ptr(), bias.data_ptr(), out.data_ptr(), ws_ptr,
            counters.data_ptr(), _build.c_ints(*d), _build.stream_of(a))

    good = list(dims)
    assert call(good) == 0
    torch.cuda.synchronize()

    def changed(i, v):  # tile_m, stages, chunk, smem, split, share at 9-14
        d = list(good)
        d[i] = v
        return d

    bad = [changed(12, good[12] + 16),  # shared bytes
           changed(9, 128),  # a split with 128-row tiles
           changed(13, good[13] - 1),  # shares short of the longest column
           changed(11, 32)]  # another chunk depth
    for d in bad:
        assert call(d) != 0, d
    assert call(good, ws_ptr=None) != 0
    assert not counters.any()


def test_f32_multiplies_are_not_implemented_on_cuda(dev):
    bsc = dense_to_bsc(np.eye(16, dtype=np.float32), (16, 16)).to(dev)
    with pytest.raises(NotImplementedError):
        bsc_spmm.bsc_spmm(torch.ones((4, 16), device=dev), bsc,
                          mxu_dtype="float32")
