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

The XBSP arms (torch ops, no kernel of this package) run in bf16 on the
card against the same arm in f32 on the CPU, on the same bf16-valued
inputs and weights, within the bf16 rule: the card's products accumulate
in f32 (cuBLAS ``out_dtype``), in place across the live blocks of a column.
The ELL gather SpMM likewise, at one ResNet-50 shape.

The packed layout (nn/fuse.pack_narrow_chains): both direct convs at the
packed shapes of ResNet-50's res2 and VGG-16's conv2_1, on weights that
``wpack.repack_weight`` builds from block-pruned logical weights, and a
packed narrow ResNet whose launches must equal what ``Net.routes`` names.

GoogLeNet's and AlexNet's shapes: ``sconv_fused`` at 5x5 kernels, K-blocks
32-112 deep, block widths 16-128 with part-filled last columns, Cin 528
padded to 640, and group=2's block-diagonal weights (also against the
dense grouped ``F.conv2d``); ``bsc_spmm`` at AlexNet's fc6; and the LRN and
s2d ops replayed from a CUDA graph.

The data slice: a Data layer's tops land on the card (pinned host copies)
as the batches of the file it reads, and the layer types of the rest of
the catalog (Deconvolution, SPP, Im2col, the recurrent layers, Embed,
BatchReindex, Filter, Parameter, N-D and stochastic pooling) give on the
card what they give on the CPU for the same f32 inputs and params, within
1e-4 relative L2 (TF32 off); stochastic pooling's TRAIN draw on a CUDA
generator picks window members.

The timer and the graph forward: ``device_time``, ``device_time_cycle``
and ``device_time_arms`` replay CUDA graphs (each pair captured once; the
arms in turn), the port's ``bench`` runs
``--per-layer --smoke`` on the card within phase 3's limit,
``Net.inference_fn(cuda_graph=True)`` replays the eager forward's results,
and a capture that would have to measure an autotune key raises.

parallel/ at world size 1, over NCCL (a group from an in-process store):
the halo path's ``engine="pallas"`` launches ``sconv_gc`` once and gives
the bits of ``sconv_gc.sconv`` on the whole map; ``tp_conv_lowered``
launches ``bsc_spmm`` once and gives the bits of the lowered route; the
halo chain and tower give the three convs run in sequence.

The examples (caffe_escoin_tpu_torch/examples/): a LeNet leg of
train_eval_sparse on the card gives the CPU's accuracies within 1/256 from
the same weights, and AlexNet on the digits, block-pruned and aligned on
the kernel routes, launches what ``Net.routes`` names.
"""

import numpy as np
import pytest
import torch

from caffe_escoin_tpu_torch.engine import autotune
from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import (_build, bsc_spmm, sconv_fused,
                                            sconv_gc)
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.sparse import dense_to_bsc
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
from caffe_escoin_tpu_torch.utils.benchmark import (device_time,
                                                    device_time_arms,
                                                    device_time_cycle)
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


# (n, h, w, cin, cout, k, stride, pad, sparsity, block, residual)
XBSP_SHAPES = {
    "3x3_c64_res_relu": (2, 14, 14, 64, 64, 3, 1, 1, 0.8, (64, 64), True),
    "3x3_c256_many_blocks_per_column": (2, 8, 8, 256, 256, 3, 1, 1, 0.6,
                                        (128, 128), True),
    "1x1_c256_to_1000_expand": (2, 7, 7, 256, 1000, 1, 1, 0, 0.8,
                                (128, 128), False),
    "3x3_s2_c40_tail": (1, 9, 11, 40, 24, 3, 2, 1, 0.7, (16, 16), False),
}


@pytest.mark.parametrize("arm", ["conv", "conv_gathered",
                                 "conv_gathered_cols"])
@pytest.mark.parametrize("name", list(XBSP_SHAPES))
def test_xbsp_arm_bf16_on_cuda_matches_cpu_f32(dev, name, arm):
    n, h, w, cin, cout, k, st, pad, sp, block, with_res = XBSP_SHAPES[name]
    rng = np.random.default_rng(3)
    al = _weight(rng, k, cin, cout, sp, block, False, dev)  # bf16 on dev
    al_cpu = al.to("cpu", torch.float32)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(
        np.float32)).bfloat16()
    ho = (h + 2 * pad - k) // st + 1
    wo = (w + 2 * pad - k) // st + 1
    res = (torch.randn((n, ho, wo, cout)).bfloat16() if with_res else None)
    fn = getattr(xbs, arm)
    kw = dict(stride=(st, st), padding=(pad, pad), relu=True)
    out = fn(x.to(dev), al, residual=None if res is None else res.to(dev),
             **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (n, ho, wo, cout)
    ref = fn(x.float(), al_cpu,
             residual=None if res is None else res.float(), **kw)
    _close(out.cpu(), ref, torch.bfloat16)


@pytest.mark.parametrize("name", ["fc1000", "ragged_k_tail_relu",
                                  "split_empty_bcol_bias_relu"])
def test_xbsp_spmm_bf16_on_cuda_matches_cpu_f32(dev, name):
    a, bsc, bias, relu = _spmm_case(name, dev, torch.bfloat16)
    out = xbs.spmm(a, bsc, bias=bias, relu=relu)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    ref = xbs.spmm(a.cpu().float(), bsc.to("cpu", torch.float32),
                   bias=bias.cpu(), relu=relu)
    _close(out.cpu(), ref, torch.bfloat16)


def _mm_operands(layout, dev):
    """(a [M, K], b [K, 128]) in bf16 on ``dev``, laid out as named. The
    first five are layouts the XBSP arms pass to ``_mm`` (a slab's or an
    fc input's columns, a channel tail); the rest are layouts they must
    not pass to a product with ``out_dtype`` as they are."""
    gen = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.randn(shape, generator=gen).bfloat16().to(dev)

    return {
        "contiguous": lambda: (r(256, 128), r(128, 128)),
        "column_slice": lambda: (r(256, 384)[:, 128:256], r(128, 128)),
        # a 1x1 slab at ResNet-50 b32's 56x56: the cin-block of x it reads
        "column_slice_b32_56x56": lambda: (
            r(32 * 56 * 56, 256)[:, 128:256], r(128, 128)),
        "channel_tail": lambda: (r(256, 3), r(128, 128)[:3]),
        "row_block_of_weight": lambda: (r(256, 64), r(4, 128, 128)[2, :64]),
        "unaligned_offset": lambda: (r(256, 130)[:, 1:129], r(128, 128)),
        "transposed_a": lambda: (r(128, 256).t(), r(128, 128)),
        "every_other_column": lambda: (r(256, 256)[:, ::2], r(128, 128)),
        "transposed_b": lambda: (r(256, 128), r(128, 128).t()),
    }[layout]()


@pytest.mark.parametrize("layout", [
    "contiguous", "column_slice", "column_slice_b32_56x56", "channel_tail",
    "row_block_of_weight",
    "unaligned_offset", "transposed_a", "every_other_column",
    "transposed_b"])
def test_xbsp_products_accumulate_in_f32_on_every_operand_layout(dev,
                                                                 layout):
    a, b = _mm_operands(layout, dev)
    ref = a.cpu().float() @ b.cpu().float()
    # what cuBLAS's out_dtype products give on the layout as it is (printed
    # with -s: the layouts _mm must hand over as unit-stride rows)
    try:
        raw = torch.mm(a, b, out_dtype=torch.float32)
        acc = torch.ones_like(raw)
        torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)
        said = (f"mm max err {(raw.cpu() - ref).abs().max().item():.3e}, "
                f"addmm into out max err "
                f"{(acc.cpu() - ref - 1).abs().max().item():.3e}")
    except RuntimeError as e:
        said = f"raises {e}"
    print(f"out_dtype products on {layout} (strides a {a.stride()}, b "
          f"{b.stride()}, offset a {a.storage_offset()}): {said}")
    out = xbs._mm(a, b)
    acc = xbs._mm(a, b, torch.ones_like(out))
    torch.cuda.synchronize()
    assert out.dtype == acc.dtype == torch.float32
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(acc.cpu(), ref + 1, rtol=1e-4, atol=1e-4)


def test_device_time_cycles_sets_and_returns_a_positive_median(dev):
    """Each set runs once eagerly, then once more while its graph is
    captured; the timed calls are replays, which run no Python."""
    xs = [torch.full((256, 256), float(i), device=dev) for i in range(4)]
    seen = []

    def f(y):
        seen.append(next(i for i, x in enumerate(xs) if x is y))
        return y @ y

    t = device_time(f, xs[0], iters=8, arg_sets=[(y,) for y in xs])
    assert t > 0
    assert seen == [0, 1, 2, 3] * 2


def test_device_time_cycle_captures_each_pair_once(dev):
    """Each (callable, args) pair, closing over its own weight, runs once
    eagerly and once while its graph is captured; the timed calls are
    replays of the pairs in turn."""
    ws = [torch.full((256, 256), float(i + 1), device=dev) for i in range(4)]
    xs = [torch.randn((256, 256), device=dev) for _ in range(4)]
    seen = []

    def pair(i):
        def f(y):
            seen.append(i)
            return y @ ws[i]
        return f, (xs[i],)

    t = device_time_cycle([pair(i) for i in range(4)], iters=8)
    assert t > 0
    assert seen == [0, 1, 2, 3] * 2


def test_device_time_arms_captures_each_arm_and_set_once(dev):
    """Each arm runs each set once eagerly and once while its graph is
    captured; the timed calls are replays, the arms in turn, and the arm
    that does twice the work reads slower."""
    xs = [torch.randn((1024, 1024), device=dev) for _ in range(4)]
    seen = []

    def arm(name, reps):
        def f(y):
            seen.append(name)
            for _ in range(reps):
                y = y @ y
            return y
        return f

    times = device_time_arms({"one": arm("one", 4), "two": arm("two", 8)},
                             [(x,) for x in xs], iters=8)
    assert 0 < times["one"] < times["two"]
    assert seen == (["one"] * 4 + ["two"] * 4) * 2


def test_bench_per_layer_smoke_on_the_card(dev, tmp_path, monkeypatch,
                                          capsys):
    """``python -m caffe_escoin_tpu_torch.bench --per-layer --smoke`` (b16):
    its line names the card, and each row's err is within 1e-2 * max|ref|
    + 1e-2 of the dense f32 conv on the same draws."""
    import json

    import torch.nn.functional as F

    from caffe_escoin_tpu_torch import bench
    from caffe_escoin_tpu_torch.utils.benchmark import device_label

    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    rows = tmp_path / "rows.jsonl"
    argv = ["--per-layer", "--smoke", "--jsonl", str(rows)]
    assert bench.main(argv) == 0
    autotune.clear()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == device_label(dev) != "cpu"
    assert line["value"] > 0
    layer_rows = [json.loads(r) for r in rows.read_text().splitlines()][:-1]
    args = bench.parse_args(argv)
    items, _ = bench.per_layer_items(args)
    assert len(layer_rows) == len(items) == 2
    for row, (key, _, xs, wp, _) in zip(layer_rows,
                                        bench.per_layer_cases(args, items)):
        h, w, cin, cout, k, s, p, g = key
        assert (row["h"], row["cin"], row["cout"], row["k"]) == (h, cin,
                                                                 cout, k)
        ref = F.conv2d(torch.from_numpy(xs[0]).to(dev).permute(0, 3, 1, 2),
                       torch.from_numpy(wp).to(dev).permute(3, 2, 0, 1),
                       stride=s, padding=p, groups=g)
        peak = ref.abs().max().item()
        assert row["err"] <= 1e-2 * peak + 1e-2, (row, peak)
        assert row["stream_rate_tb_s"] > 0 and row["t_sparse_us"] > 0


def test_device_time_reads_a_graph_replay(dev):
    """device_time's median equals CUDA events around a manual replay of
    the same captured work, within noise (25%)."""
    xs = [torch.randn((2048, 2048), device=dev) for _ in range(4)]

    def f(y):
        for _ in range(20):
            y = y * 1.0001
        return y @ y

    t = device_time(f, xs[0], iters=20, arg_sets=[(y,) for y in xs])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        f(xs[1])
    graph.replay()
    manual = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        manual.append(start.elapsed_time(end) * 1e-3)
    manual = sorted(manual)[len(manual) // 2]
    assert abs(t - manual) <= 0.25 * manual, (t, manual)


def _small_resnet(dev, policy):
    """The narrow ResNet of tests/test_torch_net.py on ``dev`` (random
    weights, pruned to 90% in 8x8 blocks, fused and aligned)."""
    from caffe_escoin_tpu_torch.models import resnet
    from caffe_escoin_tpu_torch.nn import (LayerSpec, Net, fuse_inference,
                                           params_to)

    specs, top = resnet._conv_bn("conv1", "data", 16, 7, s=2, p=3)
    for stage, mid, cout, stride in (("2", 16, 32, 1), ("3", 16, 64, 2)):
        blk, top = resnet._bottleneck(stage, 0, top, mid, cout, stride)
        specs += blk
    specs += [LayerSpec("pool5", "Pooling", (top,),
                        params=dict(mode="avg", global_pooling=True)),
              LayerSpec("fc", "InnerProduct", ("pool5",),
                        params=dict(num_output=24)),
              LayerSpec("prob", "Softmax", ("fc",))]
    shapes = {"data": (2, 32, 32, 3)}
    net = Net(specs, policy=policy)
    params = net.init(torch.Generator().manual_seed(0), shapes)
    for name, p in params.items():
        w = p.get("w")
        if w is not None and w.dim() == 4 and w.shape[2] >= 8:
            p["w"] = torch.from_numpy(prune_conv_weight(w.numpy(), 0.9,
                                                        (8, 8)))
    fnet, fparams = fuse_inference(net, params, state=net.state0)
    return fnet, params_to(fnet.weight_align(fparams), dev, torch.bfloat16)


def test_inference_fn_graph_form_matches_eager(dev):
    """The graph form on two successive, different inputs gives what the
    eager forward gives (the first call runs eagerly, the second replays),
    and the replay's outputs are overwritten by the next replay."""
    from caffe_escoin_tpu_torch.engine.context import ConvMode

    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(8, 8),
                          compute_dtype=torch.bfloat16, cast_back=False)
    fnet, aligned = _small_resnet(dev, pol)
    eager = fnet.inference_fn(aligned)
    graphed = fnet.inference_fn(aligned, cuda_graph=True)
    xs = [torch.randn((2, 32, 32, 3), device=dev) for _ in range(3)]
    outs = [graphed({"data": x})["prob"].clone() for x in xs[:2]]
    for x, out in zip(xs, outs):
        torch.testing.assert_close(out, eager({"data": x})["prob"])
    assert not torch.equal(outs[0], outs[1])
    replayed = graphed({"data": xs[2]})["prob"]
    assert replayed is graphed({"data": xs[1]})["prob"]
    torch.testing.assert_close(replayed, eager({"data": xs[1]})["prob"])


def test_graph_capture_with_an_incomplete_autotune_cache_raises(
        dev, tmp_path, monkeypatch):
    """Capturing a forward whose autotune keys are not all cached raises;
    after one eager forward the same capture succeeds."""
    from caffe_escoin_tpu_torch.engine.context import ConvMode

    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    autotune.clear()
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(8, 8),
                          compute_dtype=torch.bfloat16, cast_back=False,
                          autotune=True)
    try:
        fnet, aligned = _small_resnet(dev, pol)
        fwd = fnet.inference_fn(aligned)
        x = torch.randn((2, 32, 32, 3), device=dev)
        with pytest.raises(RuntimeError, match="capture"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                fwd({"data": x})
        fwd({"data": x})
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fwd({"data": x})
        graph.replay()
        torch.cuda.synchronize()
    finally:
        autotune.clear()


def test_ell_spmm_on_cuda_matches_cpu(dev):
    """ResNet-50 b32 res3's 3x3 conv as the ELL path runs it: the ELL of
    W^T [128, 1152] (element-wise 90%) against the im2col's transpose
    [1152, 32*28*28], bf16 on the card against the same values in f32 on
    the CPU. Both accumulate exact products in f32: only the order of the
    sums differs."""
    from caffe_escoin_tpu_torch.kernels import spmm
    from caffe_escoin_tpu_torch.sparse import dense_to_ell
    from caffe_escoin_tpu_torch.utils.pruning import prune_magnitude

    rng = np.random.default_rng(9)
    w = prune_magnitude(rng.standard_normal((128, 1152)).astype(np.float32),
                        0.9)
    ell = dense_to_ell(w, lane_pad=8).to(dtype=torch.bfloat16)
    b = torch.randn((1152, 32 * 28 * 28)).bfloat16()
    out = spmm.ell_spmm(ell.to(dev), b.to(dev))
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (128, 32 * 28 * 28)
    ref = spmm.ell_spmm(ell.to("cpu", torch.float32), b.float())
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)


def test_autotune_refuses_to_measure_during_graph_capture(dev, tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    autotune.clear()
    rng = np.random.default_rng(4)
    al = _weight(rng, 3, 64, 64, 0.9, (64, 64), False, dev)
    pol = ExecutionPolicy(block_shape=(64, 64), autotune=True,
                          compute_dtype=torch.bfloat16)
    shape = (1, 8, 8, 64)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    try:
        with torch.cuda.stream(side):
            with pytest.raises(RuntimeError, match="capture"):
                with torch.cuda.graph(graph):
                    autotune.choose_arm(al, pol, shape, (1, 1), (1, 1),
                                        (1, 1))
        # measured outside capture, then served from the cache
        arm = autotune.choose_arm(al, pol, shape, (1, 1), (1, 1), (1, 1))
        key = autotune.cache_key(al, shape, (1, 1), (1, 1), (1, 1),
                                 torch.bfloat16)
        assert key.startswith("('cuda:")
        assert set(autotune.report()[key]) == {
            "unroll", "gathered", "gathered_cols", "dense"}
        assert arm == min(autotune.report()[key],
                          key=autotune.report()[key].get)
    finally:
        autotune.clear()


def _packed_weight(rng, k, cin, cout, r_in, r_out, sw, pw, w_in, dev):
    """A logical conv weight pruned to 90% in 128x128 blocks, repacked for
    the W-pair layout and aligned (the packed layer's ``align``)."""
    from caffe_escoin_tpu_torch.ops import wpack

    w = prune_conv_weight(rng.standard_normal((k, k, cin, cout)).astype(
        np.float32) * 0.05, 0.9, (128, 128))
    wp, _, _ = wpack.repack_weight(w, r_in, r_out, sw, pw, w_in)
    b = np.tile(rng.standard_normal(cout).astype(np.float32), r_out)
    al = weight_align(wp, b, policy=ExecutionPolicy(block_shape=(128, 128)))
    return al.to(dev, torch.bfloat16)


# (n, h, w_packed, cin_logical, cout_logical, k, pad, r_in, r_out, relu,
#  residual): ResNet-50 b32's packed res2 convs and res3a's strided 1x1
#  after subsampling (stride (2, 1) on the packed map: its logical stride
#  2 over 2 packed phases), at batch 2
PACKED_SCONV_SHAPES = {
    "res2_3x3_56x28_128": (2, 56, 28, 64, 64, 3, 1, 2, 2, True, False),
    "res2_expand_1x1_128_to_512_res": (2, 56, 28, 64, 256, 1, 0, 2, 2, True,
                                       True),
    "res2_reduce_1x1_512_to_128": (2, 56, 28, 256, 64, 1, 0, 2, 2, True,
                                   False),
    "res3a_branch1_subsampled_512_to_512": (2, 28, 28, 256, 512, 1, 0, 2, 1,
                                            False, False),
}


@pytest.mark.parametrize("name", list(PACKED_SCONV_SHAPES))
def test_sconv_fused_at_packed_shapes(dev, name):
    n, h, wp, cin, cout, k, pad, r_in, r_out, relu, with_res = \
        PACKED_SCONV_SHAPES[name]
    rng = np.random.default_rng(11)
    sw = 2 if r_out == 1 else 1  # res3a: stride 2, run after subsampling
    al = _packed_weight(rng, k, cin, cout, r_in, r_out, sw, pad, wp * r_in,
                        dev)
    assert al.cin == cin * r_in and al.cout == cout * r_out
    x = torch.from_numpy(rng.standard_normal(
        (n, h, wp, cin * r_in)).astype(np.float32)).to(dev, torch.bfloat16)
    res = (torch.randn((n, h, wp, al.cout), device=dev).bfloat16()
           if with_res else None)
    launches = sconv_fused.launches
    out = sconv_fused.sconv(x, al, padding=(pad, pad), relu=relu,
                            residual=res)
    torch.cuda.synchronize()
    assert sconv_fused.launches == launches + 1
    ref = sconv_fused.sconv_plain(x, al, padding=(pad, pad), relu=relu,
                                  residual=res, mxu_dtype="bfloat16")
    _close(out, ref, torch.bfloat16)


def test_sconv_gc_at_packed_vgg_conv2_1(dev):
    """VGG-16's conv2_1 packed: [2, 112, 56, 128] -> 256 lanes, 3x3."""
    rng = np.random.default_rng(12)
    al = _packed_weight(rng, 3, 64, 128, 2, 2, 1, 1, 112, dev)
    x = torch.from_numpy(rng.standard_normal((2, 112, 56, 128)).astype(
        np.float32)).to(dev, torch.bfloat16)
    launches = sconv_gc.launches
    out = sconv_gc.sconv(x, al, padding=(1, 1), relu=True)
    torch.cuda.synchronize()
    assert sconv_gc.launches == launches + 1
    assert out.shape == (2, 112, 56, 256)
    ref = sconv_gc.sconv_plain(x, al, padding=(1, 1), relu=True,
                               mxu_dtype="bfloat16")
    _close(out, ref, torch.bfloat16)


def test_packed_narrow_net_launches_what_its_routes_name(dev):
    """The narrow ResNet of ``_small_resnet`` with a pooled stem, packed at
    lanes=32 (its 16-channel blobs at r=2), on the kernel routes in bf16:
    each kernel launches once per route that names it, and the packed
    forward agrees with the unpacked one."""
    from caffe_escoin_tpu_torch.engine.context import ConvMode
    from caffe_escoin_tpu_torch.models import resnet
    from caffe_escoin_tpu_torch.nn import (LayerSpec, Net, fuse_inference,
                                           params_to)
    from caffe_escoin_tpu_torch.nn.fuse import pack_narrow_chains
    from caffe_escoin_tpu_torch.nn.layers import ROUTE_KERNELS

    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(8, 8),
                          compute_dtype=torch.bfloat16, cast_back=False,
                          use_xla_sparse=False)
    specs, top = resnet._conv_bn("conv1", "data", 16, 7, s=2, p=3)
    specs.append(LayerSpec("pool1", "Pooling", (top,),
                           params=dict(kernel=3, stride=2)))
    top = "pool1"
    for stage, mid, cout, stride in (("2", 16, 32, 1), ("3", 16, 64, 2)):
        blk, top = resnet._bottleneck(stage, 0, top, mid, cout, stride)
        specs += blk
    specs += [LayerSpec("pool5", "Pooling", (top,),
                        params=dict(mode="avg", global_pooling=True)),
              LayerSpec("fc", "InnerProduct", ("pool5",),
                        params=dict(num_output=24))]
    shapes = {"data": (2, 32, 32, 3)}
    net = Net(specs, policy=pol)
    params = net.init(torch.Generator().manual_seed(0), shapes)
    for p in params.values():
        w = p.get("w")
        if w is not None and w.dim() == 4 and w.shape[2] >= 8:
            p["w"] = torch.from_numpy(prune_conv_weight(w.numpy(), 0.9,
                                                        (8, 8)))
    fnet, fparams = fuse_inference(net, params, state=net.state0)
    pnet = pack_narrow_chains(fnet, lanes=32)
    assert "pool1" in pnet.packed_blobs
    outs = {}
    for tag, n in (("unpacked", fnet), ("packed", pnet)):
        aligned = params_to(n.weight_align(fparams), dev, torch.bfloat16)
        routes = n.routes(aligned, shapes)
        expect = {k: 0 for k in ("sconv_fused", "sconv_gc", "bsc_spmm")}
        for r in routes.values():
            if r in ROUTE_KERNELS:
                expect[ROUTE_KERNELS[r]] += 1
        for mod in (sconv_fused, sconv_gc, bsc_spmm):
            mod.reset_counts()
        x = torch.randn((2, 32, 32, 3), generator=torch.Generator(
            ).manual_seed(1)).to(dev)
        outs[tag] = n.inference_fn(aligned)({"data": x})["fc"].float()
        torch.cuda.synchronize()
        got = {"sconv_fused": sconv_fused.launches,
               "sconv_gc": sconv_gc.launches, "bsc_spmm": bsc_spmm.launches}
        assert got == expect, (tag, routes)
        assert expect["sconv_fused"] > 0
    _close(outs["packed"], outs["unpacked"], torch.bfloat16)


# GoogLeNet b32's and AlexNet b32's conv shapes (chip_smoke.py's phase 3),
# at batch 2: (h, cin, cout, k, pad, group, relu). K-blocks 32, 96, 112, 128
# (cin 528 padded to 640) and 48 deep; block widths 96, 128 with a
# part-filled last column (208, 224, 288, 320), 24 and 16; kw = 5; group=2's
# block-diagonal weights, which 128x128 blocks cut across (conv4: 192
# channels a group)
ZOO_SCONV_SHAPES = {
    "inception_3b_5x5_28_32_to_96": (28, 32, 96, 5, 2, 1, True),
    "inception_4a_3x3_14_96_to_208": (14, 96, 208, 3, 1, 1, True),
    "inception_4b_3x3_14_112_to_224": (14, 112, 224, 3, 1, 1, True),
    "inception_4b_5x5_reduce_14_512_to_24": (14, 512, 24, 1, 0, 1, True),
    "inception_4d_3x3_14_144_to_288": (14, 144, 288, 3, 1, 1, True),
    "inception_4e_3x3_14_160_to_320": (14, 160, 320, 3, 1, 1, True),
    "inception_4e_1x1_14_528_to_256": (14, 528, 256, 1, 0, 1, True),
    "inception_4a_5x5_reduce_14_480_to_16": (14, 480, 16, 1, 0, 1, True),
    "inception_5b_5x5_7_48_to_128": (7, 48, 128, 5, 2, 1, True),
    "alexnet_conv2_27_96_to_256_group2": (27, 96, 256, 5, 2, 2, True),
    "alexnet_conv4_13_384_to_384_group2": (13, 384, 384, 3, 1, 2, True),
}


def _zoo_weight(rng, k, cin, cout, groups, dev):
    """A [k, k, cin/groups, cout] weight pruned to 90% in 128x128 blocks as
    chip_smoke.py prunes the nets', aligned (block-diagonal for groups). A
    part-full last block column keeps its centre tap live: pruning ranks it
    low (its zero padding counts in its norm)."""
    w0 = rng.standard_normal((k, k, cin // groups, cout)).astype(
        np.float32) * 0.05
    w = prune_conv_weight(w0, 0.9, (128, 128))
    c0 = cout - cout % 128
    if cout > 128 and c0 < cout:
        w[k // 2, k // 2, :, c0:] = w0[k // 2, k // 2, :, c0:]
    b = rng.standard_normal(cout).astype(np.float32)
    return weight_align(w, b, groups=groups,
                        policy=ExecutionPolicy(block_shape=(128, 128))
                        ).to(dev, torch.bfloat16)


@pytest.mark.parametrize("name", list(ZOO_SCONV_SHAPES))
def test_sconv_fused_at_googlenet_and_alexnet_shapes(dev, name):
    h, cin, cout, k, pad, groups, relu = ZOO_SCONV_SHAPES[name]
    rng = np.random.default_rng(13)
    al = _zoo_weight(rng, k, cin, cout, groups, dev)
    x = torch.from_numpy(rng.standard_normal((2, h, h, cin)).astype(
        np.float32)).to(dev, torch.bfloat16)
    assert sconv_fused.supported(x, al)
    launches = sconv_fused.launches
    out = sconv_fused.sconv(x, al, padding=(pad, pad), relu=relu)
    torch.cuda.synchronize()
    assert sconv_fused.launches == launches + 1
    assert out.shape == (2, h, h, cout)
    ref = sconv_fused.sconv_plain(x, al, padding=(pad, pad), relu=relu,
                                  mxu_dtype="bfloat16")
    _close(out, ref, torch.bfloat16)
    if groups > 1:  # the dense grouped conv the weight came from
        dense = torch.nn.functional.conv2d(
            x.float().permute(0, 3, 1, 2),
            al.dense.float().permute(3, 2, 0, 1), al.bias,
            padding=pad, groups=groups).permute(0, 2, 3, 1)
        _close(out, torch.relu(dense) if relu else dense, torch.bfloat16)


def test_bsc_spmm_at_alexnet_fc6(dev):
    """AlexNet's fc6 at b32: 32 x 9216 -> 4096, 90% of its 128x128 blocks
    pruned, ReLU: a split launch."""
    rng = np.random.default_rng(14)
    w = prune_blocks(rng.standard_normal((9216, 4096)).astype(np.float32)
                     * 0.02, 0.9, (128, 128))
    bsc = dense_to_bsc(w, (128, 128)).to(dev, torch.bfloat16)
    assert bsc_spmm.launch_plan(32, bsc).split > 1
    a = torch.from_numpy(rng.standard_normal((32, 9216)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                            ).to(dev)
    launches = bsc_spmm.launches
    out = bsc_spmm.bsc_spmm(a, bsc, bias=bias, relu=True)
    torch.cuda.synchronize()
    assert bsc_spmm.launches == launches + 1
    ref = bsc_spmm.bsc_spmm_plain(a, bsc, bias=bias, relu=True,
                                  mxu_dtype="bfloat16")
    _close(out, ref, torch.bfloat16)


def test_lrn_and_s2d_capture_in_a_cuda_graph(dev):
    """The packed LRN's masks and the s2d stem's pad and crop build no
    tensor per call: both replay from a CUDA graph and agree with eager."""
    from caffe_escoin_tpu_torch.ops import norm as norm_ops
    from caffe_escoin_tpu_torch.ops import s2d as s2d_ops

    x = torch.randn((2, 14, 14, 64), device=dev).bfloat16()
    img = torch.randn((2, 21, 21, 3), device=dev).bfloat16()

    def fwd():
        return (norm_ops.lrn_across_channels(x, groups=2),
                s2d_ops.s2d_input(img, 2, (2, 2), (0, 0)))

    eager = fwd()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fwd()
    graph.replay()
    torch.cuda.synchronize()
    assert captured[1].shape == (2, 10, 10, 12)  # cropped to the conv's 10
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arm", ["conv", "conv_gathered",
                                 "conv_gathered_cols", "spmm"])
def test_xbsp_arm_backward_bf16_on_cuda_matches_cpu_f32(dev, arm):
    """With grad enabled the arms are differentiable on the card (their
    bf16 products go out of place in f32: autograd takes neither
    ``out_dtype`` nor ``out=``); under inference_mode the forward is the
    in-place one. Gradients of x and of the live payloads against the same
    arm's in f32 on the CPU."""
    import dataclasses

    rng = np.random.default_rng(4)
    if arm == "spmm":
        w = prune_blocks(rng.standard_normal((384, 256)).astype(np.float32),
                         0.6, (128, 128))
        bsc = dense_to_bsc(w, (128, 128))
        x = torch.from_numpy(rng.standard_normal((32, 384)).astype(
            np.float32)).bfloat16()

        def run(x, blocks):
            return xbs.spmm(x, dataclasses.replace(bsc.to(x.device),
                                                   blocks=blocks))
        blocks = bsc.blocks
    else:
        al = _weight(rng, 3, 64, 64, 0.8, (64, 64), False, dev)
        x = torch.from_numpy(rng.standard_normal((2, 14, 14, 64)).astype(
            np.float32)).bfloat16()
        blocks = al.bsc.blocks.cpu()

        def run(x, blocks):
            a = al.to(x.device)
            a = dataclasses.replace(a, bsc=dataclasses.replace(a.bsc,
                                                               blocks=blocks))
            return getattr(xbs, arm)(x, a, padding=(1, 1), relu=False)

    grads = {}
    for where, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
        xg = x.to(where, dtype).requires_grad_(True)
        bg = blocks.to(where, dtype).requires_grad_(True)
        out = run(xg, bg)
        grads[str(torch.device(where).type)] = torch.autograd.grad(
            out.float().sum(), [xg, bg])
    with torch.inference_mode():
        fast = run(x.to(dev), blocks.to(dev, torch.bfloat16))
    torch.cuda.synchronize()
    assert fast.dtype == torch.bfloat16
    _close(fast.cpu(), run(x.float(), blocks.float()).detach(),
           torch.bfloat16)
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got.cpu().float(), ref, rtol=2e-2,
                                   atol=2e-2 * ref.abs().max().item())


def test_layerwise_backward_times_on_cuda(dev):
    """``time_net_layerwise(backward=True)`` on the card: every layer's
    forward and backward captured and replayed as CUDA graphs; the rows
    with a backward time are the CPU run's."""
    from caffe_escoin_tpu_torch.engine.context import ConvMode
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, params_to
    from caffe_escoin_tpu_torch.utils.timing import time_net_layerwise

    net = Net(ZOO["cifar10_quick"][0](), policy=ExecutionPolicy(
        conv_mode=ConvMode.SCONV_PAR, block_shape=(128, 128)))
    shapes = {"data": (4, 32, 32, 3)}
    params = net.init(torch.Generator().manual_seed(0), shapes)
    for name in ("conv2", "conv3"):
        params[name]["w"] = torch.from_numpy(prune_conv_weight(
            params[name]["w"].numpy(), 0.9, (128, 128)))
    aligned = net.weight_align(params)
    x = torch.randn(shapes["data"])
    rows = {}
    for where in ("cpu", dev):
        res = time_net_layerwise(net, params_to(aligned, where),
                                 {"data": x.to(where)}, iters=2,
                                 backward=True)
        rows[str(torch.device(where).type)] = {
            r["name"] for r in res["layers"] if r["bwd_ms"] > 0}
        assert all(r["ms"] > 0 for r in res["layers"])
    assert rows["cuda"] == rows["cpu"]
    assert rows["cuda"] >= {"conv1", "ip1", "ip2", "pool1"}
    assert not rows["cuda"] & {"conv2", "conv3"}


def test_lenet_solver_step_on_cuda_matches_cpu(dev):
    """One lenet Solver step (SGD, momentum, weight decay) on the card
    against the same step on the CPU from the same params: the loss within
    1e-5 relative, each param's update within 1e-3 relative L2 (cuDNN and
    the CPU sum the convs in another order; TF32 is off)."""
    from caffe_escoin_tpu_torch.engine.solver import Solver
    from caffe_escoin_tpu_torch.engine.solvers import SolverConfig
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, params_to

    shapes = {"data": (8, 28, 28, 1), "label": (8,)}
    rng = np.random.default_rng(0)
    batch = {"data": rng.standard_normal(shapes["data"]).astype(np.float32),
             "label": rng.integers(0, 10, 8).astype(np.int32)}
    sols = {}
    for where in ("cpu", dev):
        sol = Solver(Net(ZOO["lenet"][0](include_loss=True), phase="train"),
                     SolverConfig(base_lr=0.01, momentum=0.9,
                                  weight_decay=5e-4), display=0,
                     device=where)
        sol.init(shapes)  # the same CPU generator seed on both
        before = params_to(sol.params, "cpu")
        before = {n: {k: v.clone() for k, v in b.items()}
                  for n, b in before.items()}
        sol.step(iter([batch]), 1, log=lambda *_: None)
        sols[torch.device(where).type] = (sol, before)
    (cpu, b_cpu), (gpu, b_gpu) = sols["cpu"], sols["cuda"]
    assert gpu.params["conv1"]["w"].is_cuda
    np.testing.assert_allclose(gpu._losses[-1], cpu._losses[-1], rtol=1e-5)
    for name, blobs in cpu.params.items():
        for k, w in blobs.items():
            assert torch.equal(b_gpu[name][k], b_cpu[name][k])
            d_cpu = w - b_cpu[name][k]
            d_gpu = gpu.params[name][k].cpu() - b_gpu[name][k]
            rel = (d_gpu - d_cpu).norm() / d_cpu.norm()
            assert rel <= 1e-3, (name, k, float(rel))


def test_dropout_on_a_cuda_generator(dev):
    """The mask is drawn on the card from its generator: the same seed
    gives the same mask, survivors are x/(1-p), and the zero share is
    within a binomial 5-sigma bound."""
    from caffe_escoin_tpu_torch.ops import activations as act

    x = torch.randn((256, 1024), device=dev)
    outs = [act.dropout(x, 0.5, train=True, generator=torch.Generator(
        device=dev).manual_seed(s)) for s in (3, 3, 4)]
    assert outs[0].is_cuda and torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    kept = outs[0] != 0
    assert torch.equal(outs[0][kept], x[kept] / 0.5)
    share = 1.0 - kept.float().mean().item()
    assert abs(share - 0.5) <= 5 * (0.25 / x.numel()) ** 0.5


def test_data_layer_tops_land_on_the_card(dev, tmp_path):
    """A net whose device is None (the card) gets the Data layer's batches
    there, the records of the file in order; inference_fn refuses to
    capture it."""
    from caffe_escoin_tpu_torch.data import datasets
    from caffe_escoin_tpu_torch.nn import LayerSpec, Net

    rng = np.random.default_rng(0)
    data = rng.standard_normal((6, 5, 5, 3)).astype(np.float32)
    path = str(tmp_path / "d.cerec")
    datasets.write_cerec(path, data, np.arange(6))
    net = Net([LayerSpec("data", "Data", (), ("data", "label"),
                         params=dict(source=path, batch_size=4)),
               LayerSpec("pool", "Pooling", ("data",),
                         params=dict(kernel=2, stride=2))])
    try:
        params = net.init(torch.Generator().manual_seed(0), {})
        for first in (0, 4):
            out = net(params, {}, return_blobs=True)
            assert out["data"].is_cuda and out["label"].is_cuda
            idx = [(first + i) % 6 for i in range(4)]
            np.testing.assert_array_equal(out["data"].cpu().numpy(),
                                          data[idx])
            assert out["label"].cpu().tolist() == idx
        with pytest.raises(ValueError, match="Data"):
            net.inference_fn(params, cuda_graph=True)
    finally:
        net.close()


# (type, params, bottoms): a shape is a normal f32 bottom; "cont" the [T, N]
# indicator, "idx" indices into 10 rows, "reindex" 5 batch indices, "sel"
# a selector over 6 items, "pos" a positive map
CATALOG_CASES = [
    ("Deconvolution", dict(num_output=8, kernel=4, stride=2, pad=1),
     [(2, 14, 14, 16)]),
    ("SPP", dict(pyramid_height=3), [(2, 13, 13, 8)]),
    ("Im2col", dict(kernel=3, stride=2, pad=1), [(2, 9, 9, 4)]),
    ("RNN", dict(num_output=16), [(6, 4, 8), "cont"]),
    ("LSTM", dict(num_output=16), [(6, 4, 8), "cont"]),
    ("LSTMUnit", {}, [(4, 16), (4, 64), (4,)]),
    ("Embed", dict(input_dim=10, num_output=12), ["idx"]),
    ("BatchReindex", {}, [(6, 3, 2), "reindex"]),
    ("Filter", {}, [(6, 3, 2), "sel"]),
    ("Parameter", dict(shape=(3, 4), filler={"type": "gaussian"}), []),
    ("Convolution", dict(num_output=6, kernel=3, pad=1), [(2, 4, 6, 6, 4)]),
    ("Pooling", dict(kernel=3, stride=2, mode="stochastic"), ["pos"]),
]


def _catalog_inputs(bottoms, rng):
    out = {}
    for i, b in enumerate(bottoms):
        if b == "cont":
            v = np.ones((6, 4), np.float32)
            v[0] = 0
        elif b == "idx":
            v = rng.integers(0, 10, (5, 3)).astype(np.int64)
        elif b == "reindex":
            v = rng.integers(0, 6, 5).astype(np.int64)
        elif b == "sel":
            v = np.array([1, 0, 1, 1, 0, 1], np.float32)
        elif b == "pos":
            v = rng.uniform(0.1, 2.0, (2, 9, 9, 4)).astype(np.float32)
        else:
            v = rng.standard_normal(b).astype(np.float32)
        out[f"in{i}"] = v
    return out


@pytest.mark.parametrize("case", CATALOG_CASES, ids=[
    f"{c[0]}{'_3d' if c[0] == 'Convolution' else ''}" for c in
    CATALOG_CASES])
def test_catalog_layer_on_cuda_matches_cpu(dev, case):
    from caffe_escoin_tpu_torch.nn import LayerSpec, Net, params_to

    kind, params, bottoms = case
    xs = _catalog_inputs(bottoms, np.random.default_rng(0))
    net = Net([LayerSpec("l", kind, tuple(xs), ("t0", "t1")[:2 if kind in (
        "LSTMUnit", "Filter") else 1], params=params)])
    p = net.init(torch.Generator().manual_seed(0),
                 {k: v.shape for k, v in xs.items()})
    cpu = net(p, {k: torch.from_numpy(v) for k, v in xs.items()})
    gpu = net(params_to(p, dev), {k: torch.from_numpy(v).to(dev)
                                  for k, v in xs.items()})
    assert set(cpu) == set(gpu)
    for k, ref in cpu.items():
        got = gpu[k]
        assert got.is_cuda and got.shape == ref.shape
        rel = ((got.cpu().double() - ref.double()).norm()
               / ref.double().norm().clamp_min(1e-30)).item()
        assert rel <= 1e-4, (kind, k, rel)


def test_stochastic_pool_train_on_a_cuda_generator(dev):
    from caffe_escoin_tpu_torch.ops.pool import pool2d

    x = torch.rand((4, 8, 8, 16), device=dev) + 0.1
    a, b = (pool2d(x, (2, 2), stride=(2, 2), mode="stochastic", train=True,
                   generator=torch.Generator(device=dev).manual_seed(1))
            for _ in range(2))
    assert a.is_cuda and torch.equal(a, b)
    win = x.reshape(4, 4, 2, 4, 2, 16).permute(0, 1, 3, 5, 2, 4).reshape(
        4, 4, 4, 16, 4)
    assert ((win == a[..., None]).any(-1)).all()


@pytest.fixture
def mesh1(dev):
    """A (1, 1) mesh over a world of one NCCL rank, made for the test."""
    import torch.distributed as dist

    from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib

    made = not dist.is_initialized()
    mesh_lib.multihost_init(platform="cuda")
    try:
        yield mesh_lib.make_mesh()
    finally:
        if made:
            dist.destroy_process_group()


def _kernel_policy():
    from caffe_escoin_tpu_torch.engine.context import ConvMode

    return ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(64, 64),
                           use_xla_sparse=False)


def test_halo_pallas_engine_at_world1_is_sconv_gc(dev, mesh1):
    from caffe_escoin_tpu_torch.parallel import halo

    rng = np.random.default_rng(0)
    pol = _kernel_policy()
    al = _weight(rng, 3, 64, 64, 0.75, (64, 64), False, dev)
    x = torch.from_numpy(rng.standard_normal((2, 16, 20, 64)).astype(
        np.float32)).to(dev, torch.bfloat16)
    sconv_gc.reset_counts()
    got = halo.spatial_sconv2d(x, al, mesh=mesh1, padding=(1, 1), policy=pol,
                               relu=True, engine="pallas")
    assert sconv_gc.launches == 1
    want = sconv_gc.sconv(x, al, padding=(1, 1), relu=True)
    assert torch.equal(got, want)


def test_tp_conv_lowered_at_world1_is_the_lowered_route(dev, mesh1):
    from caffe_escoin_tpu_torch.ops.conv import conv2d_lowered_sparse
    from caffe_escoin_tpu_torch.parallel import tp

    rng = np.random.default_rng(1)
    pol = _kernel_policy()
    al = _weight(rng, 3, 64, 64, 0.75, (64, 64), False, dev)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 64)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bsc_spmm.reset_counts()
    got = tp.tp_conv_lowered(x, al, mesh=mesh1, padding=(1, 1), relu=True,
                             policy=pol)
    assert bsc_spmm.launches == 1
    want = conv2d_lowered_sparse(x, al, stride=(1, 1), padding=(1, 1),
                                 dilation=(1, 1), relu=True, policy=pol)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["chain", "tower"])
def test_halo_stack_at_world1_is_the_convs_in_sequence(dev, mesh1, kind):
    from caffe_escoin_tpu_torch.ops import conv as conv_ops
    from caffe_escoin_tpu_torch.parallel import halo

    rng = np.random.default_rng(2)
    pol = _kernel_policy()
    als = [_weight(rng, k, cin, cout, 0.75, (64, 64), False, dev)
           for k, cin, cout in ((3, 64, 128), (1, 128, 128), (3, 128, 64))]
    x = torch.from_numpy(rng.standard_normal((2, 12, 12, 64)).astype(
        np.float32)).to(dev, torch.bfloat16)
    fn = (halo.spatial_sconv_chain if kind == "chain"
          else halo.spatial_sconv_tower)
    got = fn(x, als, mesh=mesh1, policy=pol, relu=True)
    want = x
    for a in als:
        p = (a.kernel_shape[0] - 1) // 2
        want = conv_ops.conv2d(want, a, padding=(p, p), relu=True,
                               policy=pol)
    assert got.shape == want.shape
    ref = want.float()
    err = (got.float() - ref).abs().max().item()
    assert err <= 1e-2 * ref.abs().max().item() + 1e-2, err


def _example_args(**kw):
    from caffe_escoin_tpu_torch.examples import train_eval_sparse

    args = train_eval_sparse.parse_args([])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_example_lenet_leg_on_cuda_matches_cpu(dev, tmp_path):
    """The one-shot block-90% LeNet leg of examples/train_eval_sparse.py
    (5 masked fine-tune steps, then dense and aligned scoring of the 256
    test digits) on the card and on the CPU from the same weights (the
    port's init): each accuracy within 1/256 (cuDNN's f32 sums and the
    XBSP arms' bf16 products on the card)."""
    from caffe_escoin_tpu_torch.examples.train_eval_sparse import (
        Experiment, clone)
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, params_to

    base = Net(ZOO["lenet"][0](include_loss=True)).init(
        torch.Generator().manual_seed(0),
        {"data": (1, 28, 28, 1), "label": (1,)})
    rows = {}
    for where in ("cpu", "cuda"):
        exp = Experiment(_example_args(platform=where, finetune_iters=5,
                                       workdir=str(tmp_path / where)),
                         log=lambda *_: None)
        try:
            exp.base_params = params_to(clone(base), exp.device)
            exp.base_state = {}
            rows[where] = exp.oneshot("block", (8, 8), 0.9)
            assert exp.solver.params["ip1"]["w"].device.type == where
        finally:
            exp.close()
    for key in ("acc_pruned", "acc_finetuned", "acc_sparse_exec"):
        assert abs(rows["cuda"][key] - rows["cpu"][key]) <= 1 / 256 + 1e-9, (
            key, rows)
    assert rows["cuda"]["achieved_sparsity"] == rows["cpu"][
        "achieved_sparsity"]


def test_example_alexnet_on_the_kernel_routes_launches_its_routes(dev):
    """AlexNet on the digits (examples/train_eval_sparse.py's model, xavier
    fillers, 10 classes), its conv2-5 and fc6-8 pruned to 90% in 128x128
    blocks (the gradual leg's selection, fc8 4096x10 included: its BSC has
    bn = 16), aligned in SCONV_PAR with ``use_xla_sparse=False``: scoring
    one batch of 64 launches what ``Net.routes`` names, 4 sconv_fused and
    3 bsc_spmm."""
    from caffe_escoin_tpu_torch.engine.context import ConvMode
    from caffe_escoin_tpu_torch.examples.digits import load_digits_upscaled
    from caffe_escoin_tpu_torch.examples.train_eval_sparse import (
        evaluate, gradual_select, model_specs)
    from caffe_escoin_tpu_torch.nn import Net
    from caffe_escoin_tpu_torch.nn.layers import ROUTE_KERNELS
    from caffe_escoin_tpu_torch.utils.pruning import gradual_masks

    specs = model_specs("alexnet", "xavier", include_loss=True)
    shapes = {"data": (64, 227, 227, 3), "label": (64,)}
    params = Net(specs).init(torch.Generator().manual_seed(0), shapes)
    masks = gradual_masks(params, 0.9, block_shape=(128, 128),
                          select=gradual_select)
    params = {n: {k: v * torch.as_tensor(masks[n][k]) for k, v in p.items()}
              for n, p in params.items()}
    net = Net(specs, phase="test", device=dev, policy=ExecutionPolicy(
        conv_mode=ConvMode.SCONV_PAR, block_shape=(128, 128),
        sparse_threshold=0.4, sconv_threshold=0.4, use_xla_sparse=False))
    aligned = net.weight_align(params)
    assert aligned["fc8"].bsc.block_shape[1] == 16
    routes = net.routes(aligned, shapes)
    expect = {k: sum(ROUTE_KERNELS.get(r) == k for r in routes.values())
              for k in ("sconv_fused", "bsc_spmm", "sconv_gc")}
    assert expect == {"sconv_fused": 4, "bsc_spmm": 3, "sconv_gc": 0}, routes
    _, (ted, tel) = load_digits_upscaled(227, 3)
    for m in (sconv_fused, bsc_spmm, sconv_gc):
        m.reset_counts()
    acc = evaluate(net, aligned, {}, ted[:64], tel[:64])
    torch.cuda.synchronize()
    assert 0.0 <= acc <= 1.0
    assert {"sconv_fused": sconv_fused.launches, "bsc_spmm": bsc_spmm.launches,
            "sconv_gc": sconv_gc.launches} == expect
