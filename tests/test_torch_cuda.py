"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device and run on the machine with
the card, which has no jax, so without tests/conftest.py (it imports jax):
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``. The
first launch builds the kernels with nvcc (kernels/_build.py).

Tolerance: max |kernel - plain| <= 1e-2 * max|plain| + 1e-2 in bf16 (the
output's bf16 rounding and another order of the f32 sums; the plain version
rounds the operands to bf16 as the kernel does), 2e-3 relative for f32
activations (operands are still multiplied in bf16 on both sides). With
``mxu_dtype="float32"`` (three TF32 products per multiply) each kernel is
held to its plain version computed in f64: 2e-5 * max|plain| for f32
outputs, which one TF32 pass would miss by more than 10x, and 2**-8 *
max|plain| for bf16 outputs (their one rounding).

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

The LRN kernel (csrc/lrn.cu) against its plain version on the card, at
GoogLeNet's norm1 and norm2 (b32, b8, packed), over groups {1, 2, 4},
local_size {5, 4}, beta {0.75, 0.5}, C not a multiple of 8 and
local_size 3 and 1: f32 within rtol 1e-5, atol 1e-6 (the same f32
operations, rsqrt and powf may round apart), bf16 at most one bf16 ulp
apart; its gradient is the plain version's.

The max-pool kernel (csrc/maxpool.cu) against its plain version on the
card, bit for bit (NaN where it has NaN): every max pool of the benchmark's
three configurations at b8 and b32, f32 maps, C = 20 and C = 3, a map of
ties, -inf, signed zeros and NaN, and windows off the kernel's ring (spp's,
3x2 at stride (2, 1)); an empty map gets an empty output and no launch;
its gradient is the plain version's, and a captured forward of GoogLeNet,
ResNet-50 and VGG-16 launches it once a max pool (13, 1, 5), with no
``max_pool_forward_nhwc`` left in a profiled forward.

The dense conv's epilogue (csrc/conv_epilogue.cu): ``conv2d_dense`` on the
card is ``torch.equal`` to the former ``F.conv2d`` with the bias and
``torch.relu``, bit for bit, at ResNet-50's conv1 b32 in f32, GoogLeNet's
inception_3a/5x5 b8, VGG-16's conv1_2 b32, an f32 conv and one with a
residual; an NCHW output is read through its strides, misaligned operands
take the scalar path; a captured forward of ResNet-50's and GoogLeNet's
configurations launches it once a dense conv but the stem (1, 9), as
``Net.launches`` declares.

The stem conv (csrc/stem_conv.cu) at the zoo's four stems (AlexNet's
11x11/s4, ResNet-50's and GoogLeNet's 7x7/s2/p3, VGG-16's 3x3/s1/p1) at
b1 and b32, and at odd shapes with ragged last tiles, Cin 1 and 4 and
Cout 40 (a padded width): against its plain version (cuDNN in bf16, the
bias rounded to bf16 and added, ReLU) within the bf16 rule above, and
against the same conv in f64 within one bf16 rounding of each output
(2**-8 of its magnitude, plus 1e-5 of the largest for the order of the f32
sums): the kernel adds the f32 bias and rounds once. ``conv2d_dense``
launches it once a bf16 stem, ``gemm_weight`` built once into an aligned
weight's memo; a NaN pixel stays inside its own windows.

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
a capture that would have to measure an autotune key raises, and VGG-16
b32 autotuned, set up by the benchmark's ``portbench/`` from its
configuration, routes every pruned layer as autotune picked it and meets
the configuration's limit against the plain reference; AlexNet b32, set
up the same way from ``alexnet-block90`` on the kernel routes, captures
``sconv_fused`` / ``bsc_spmm`` / ``lrn`` / ``maxpool`` / ``conv_epilogue``
4 / 3 / 2 / 3 / 1 times, as ``Net.launches`` declares, within its limit.

parallel/ at world size 1, over NCCL (a group from an in-process store):
the halo path's ``engine="pallas"`` launches ``sconv_gc`` once and gives
the bits of ``sconv_gc.sconv`` on the whole map; ``tp_conv_lowered``
launches ``bsc_spmm`` once and gives the bits of the lowered route; the
halo chain and tower give the three convs run in sequence.

The examples (caffe_escoin_tpu_torch/examples/): a LeNet leg of
train_eval_sparse on the card gives the CPU's accuracies within 1/256 from
the same weights, and AlexNet on the digits, block-pruned and aligned on
the kernel routes, launches what ``Net.routes`` names.

``weights_as_args`` and the probes: ResNet-50 b8's graph-replay forward
over grafted payloads gives the closed-over graph's output bit for bit
(the XBSP executor and the kernel routes), and the k3 probe's
``fused_cuda`` arm launches ``sconv_fused`` once a call within phase 3's
rule of the f32 dense conv.
"""

import numpy as np
import pytest
import torch

from caffe_escoin_tpu_torch.engine import autotune
from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import (_build, bsc_spmm, lrn, maxpool,
                                            sconv_fused, sconv_gc)
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.ops import conv as conv_ops
from caffe_escoin_tpu_torch.ops import pool as pool_ops
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


def _weight(rng, k, cin, cout, sp, block, empty_bcol, dev,
            dtype=torch.bfloat16):
    """A pruned conv weight aligned to BSC on ``dev`` in ``dtype``;
    ``empty_bcol`` zeroes its last block-column, so the BSC has a column
    with no live block."""
    wt = prune_conv_weight(
        rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05, sp,
        (min(block[0], cin), block[1]))
    if empty_bcol:
        wt[..., (cout - 1) // block[1] * block[1]:] = 0
    b = rng.standard_normal(cout).astype(np.float32)
    al = weight_align(wt, b, policy=ExecutionPolicy(block_shape=block))
    if empty_bcol:
        assert int(al.bsc.bcol_nnz[-1]) == 0
    return al.to(dev, dtype)


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
    with pytest.raises(ValueError):  # in f32 too: nothing falls back
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


def _spmm_case(name, dev, dtype, seed=1, wdtype=torch.bfloat16):
    m, k, n, block, sp, relu, empty = SPMM_SHAPES[name]
    rng = np.random.default_rng(seed)
    w = prune_blocks(rng.standard_normal((k, n)).astype(np.float32), sp, block)
    if empty:
        w[:, (n - 1) // block[1] * block[1]:] = 0
    bsc = dense_to_bsc(w, block).to(dev, wdtype)
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


F32_REL = 2e-5


def _close_f64(out, ref, dtype):
    """``out`` of a kernel that multiplied in f32 against its plain version
    in f64: 2e-5 * max|ref| for an f32 output, 2**-8 * max|ref| for a bf16
    one (rounded once, after the f32 epilogue)."""
    out, ref = out.double(), ref.double()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    bound = (F32_REL if dtype == torch.float32 else 2.0 ** -8) * scale
    assert torch.isfinite(out).all()
    assert err <= bound, (err, bound, scale)


def _f32_launch(mod, fn):
    """fn() with the kernel module's counts read around it: one launch,
    and it multiplied in f32."""
    before = (mod.launches, mod.launches_f32)
    out = fn()
    torch.cuda.synchronize()
    assert (mod.launches, mod.launches_f32) == (before[0] + 1, before[1] + 1)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SCONV_SHAPES))
def test_sconv_kernel_f32_multiplies_match_f64(dev, name, dtype):
    n, h, w, cin, cout, k, pad, sp, relu, with_res, block, empty = \
        SCONV_SHAPES[name]
    rng = np.random.default_rng(0)
    al = _weight(rng, k, cin, cout, sp, block, empty, dev, torch.float32)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(
        np.float32)).to(dev, dtype)
    res = torch.randn((n, h, w, cout), device=dev).to(dtype) \
        if with_res else None
    out = _f32_launch(sconv_fused, lambda: sconv_fused.sconv(
        x, al, padding=(pad, pad), relu=relu, residual=res,
        mxu_dtype="float32"))
    assert out.dtype == dtype and out.shape == (n, h, w, cout)
    ref = sconv_fused.sconv_plain(
        x.double(), al, padding=(pad, pad), relu=relu,
        residual=None if res is None else res.double(), mxu_dtype="float32")
    _close_f64(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(GC_SHAPES))
def test_sconv_gc_kernel_f32_multiplies_match_f64(dev, name, dtype):
    n, h, w, cin, cout, k, pad, sp, relu, block, empty = GC_SHAPES[name]
    rng = np.random.default_rng(2)
    al = _weight(rng, k, cin, cout, sp, block, empty, dev, torch.float32)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(
        np.float32)).to(dev, dtype)
    out = _f32_launch(sconv_gc, lambda: sconv_gc.sconv(
        x, al, padding=(pad, pad), relu=relu, mxu_dtype="float32"))
    assert out.dtype == dtype
    ref = sconv_gc.sconv_plain(x.double(), al, padding=(pad, pad), relu=relu,
                               mxu_dtype="float32")
    _close_f64(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SPMM_SHAPES))
def test_bsc_spmm_kernel_f32_multiplies_match_f64(dev, name, dtype):
    """Split and unsplit: the split-K partial sums stay f32."""
    a, bsc, bias, relu = _spmm_case(name, dev, dtype, wdtype=torch.float32)
    out = _f32_launch(bsc_spmm, lambda: bsc_spmm.bsc_spmm(
        a, bsc, bias=bias, relu=relu, mxu_dtype="float32"))
    assert out.dtype == dtype and out.shape == (a.shape[0], bsc.shape[1])
    ref = bsc_spmm.bsc_spmm_plain(a.double(), bsc, bias=bias, relu=relu,
                                  mxu_dtype="float32")
    _close_f64(out, ref, dtype)


def test_f32_multiplies_widen_bf16_weights(dev):
    """bf16 weight blocks under mxu_dtype="float32" are widened, not
    rejected: the same bits as the weights stored in f32."""
    a, bsc16, bias, relu = _spmm_case("fc1000", dev, torch.float32)
    bsc32 = bsc16.to(dev, torch.float32)
    got = [bsc_spmm.bsc_spmm(a, b, bias=bias, relu=relu, mxu_dtype="float32")
           for b in (bsc16, bsc32)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])


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
                    conv_ops.measured_arm(al, pol, shape, (1, 1), (1, 1),
                                          (1, 1))
        # measured outside capture, then served from the cache
        arm = conv_ops.measured_arm(al, pol, shape, (1, 1), (1, 1), (1, 1))
        key = autotune.cache_key(al, shape, (1, 1), (1, 1), (1, 1),
                                 torch.bfloat16)
        assert key.startswith("('cuda:")
        # the fused kernel competes wherever it runs the shape
        x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
        fused = conv_ops.fused_gate(x, al, (1, 1))
        assert set(autotune.report()[key]) == {
            "unroll", "gathered", "gathered_cols", "dense"} | (
            {"fused"} if fused else set())
        assert arm == min(autotune.report()[key],
                          key=autotune.report()[key].get)
    finally:
        autotune.clear()


def test_vgg16_b32_autotuned_through_the_graph_entry(dev):
    """VGG-16 b32 set up as the benchmark's ``vgg16-block90-autotuned``
    configuration sets it up (``portbench/``: seeded weights, 90% of
    128x128 blocks pruned in 12 convs and 3 fcs, SCONV_PAR on the XBSP
    branch, autotune, no cache file), through ``inference_fn(cuda_graph=
    True)``: the first call measures every pruned layer's arms, the
    capture counts one ``autotune.pick.*`` for each of the 15 pruned
    layers, every pruned layer's route is its autotuned pick (an fc's the
    fastest measured), the capture launches the stem kernel once for the
    dense stem and the epilogue kernel once for each dense pick, as
    ``Net.launches`` declares, and the replayed logits are within the
    configuration's
    ``logit_rel_err`` of the plain f32 reference."""
    from pathlib import Path

    from portbench import check, harness, weights
    from portbench.system import PortSystem

    from caffe_escoin_tpu_torch.utils import trace

    bench = harness.Bench(Path(__file__).resolve().parents[1])
    cfg = bench.config("vgg16-block90-autotuned")
    seed = 2 ** 31 + 7
    table, params, pruned = weights.make_net(
        cfg, bench.reference(cfg["reference"]), seed, dev)
    assert len(pruned) == 15
    hwc = tuple(cfg["input_hwc"])
    pool = weights.images(2 * 32, hwc, weights.generator(
        seed, weights.POOL, dev), dev).view(2, 32, *hwc)
    autotune.clear()
    before = trace.snapshot()["counters"]
    system = PortSystem(cfg, table, params, dev)
    try:
        # the first query measures and captures, the second replays
        kept = [(j, system.query(pool[j])) for j in range(2)]
        after = trace.snapshot()["counters"]
        grew = {k: n - before.get(k, 0) for k, n in after.items()
                if k.startswith("autotune.") and n != before.get(k, 0)}
        assert sum(n for k, n in grew.items()
                   if k.startswith("autotune.pick.")) == 15, grew
        assert grew["autotune.measured.fc"] == 3, grew
        with autotune.record_keys() as served:
            routes = system.net.routes(system.aligned,
                                       {"data": tuple(pool[0].shape)})
        # the stem on its kernel, the dense picks one epilogue launch each
        declared = system.net.launches(system.aligned, {"data": tuple(
            pool[0].shape)}, torch.bfloat16)
        epilogue, stem = ("capture.launches.conv_epilogue",
                          "capture.launches.stem_conv")
        assert after[epilogue] - before.get(epilogue, 0) == (
            declared["conv_epilogue"]) == sum(
            r == "dense" for n, r in routes.items()
            if not n.startswith("fc")) - 1
        assert after[stem] - before.get(stem, 0) == declared["stem_conv"] == 1
        order = [name for name in routes if name in pruned]
        assert len(order) == len(served) == 15
        times = autotune.report()
        for name, (key, arm) in zip(order, served):
            assert routes[name] == {"bsc_spmm": "spmm"}.get(arm, arm), name
            if name.startswith("fc"):
                assert arm == min(times[key], key=times[key].get), name
        numbers, _ = check.against_reference(table, params, pool, kept, cfg)
        print(f"vgg16 b32 autotuned: routes {routes}; {numbers}")
        assert numbers["logit_rel_err"] <= cfg["limits"]["logit_rel_err"]
    finally:
        system.close()
        autotune.clear()


def test_alexnet_b32_captured_launches(dev):
    """AlexNet b32 set up as the benchmark's ``alexnet-block90``
    configuration sets it up (``portbench/``: seeded weights, 90% of
    128x128 blocks pruned in conv2-5 and fc6-8, SCONV_PAR on the kernel
    routes, bf16, fused), through ``inference_fn(cuda_graph=True)``: the
    capture launches ``sconv_fused`` / ``bsc_spmm`` / ``lrn`` / ``maxpool``
    / ``conv_epilogue`` / ``stem_conv`` 4 / 3 / 2 / 3 / 0 / 1 times, as
    ``Net.launches`` declares, and the replayed logits are within the
    configuration's ``logit_rel_err`` of the plain f32 reference."""
    from pathlib import Path

    from portbench import check, harness, weights
    from portbench.system import PortSystem

    from caffe_escoin_tpu_torch.utils import trace

    bench = harness.Bench(Path(__file__).resolve().parents[1])
    cfg = bench.config("alexnet-block90")
    seed = 2 ** 31 + 26
    table, params, pruned = weights.make_net(
        cfg, bench.reference(cfg["reference"]), seed, dev)
    assert len(pruned) == 7
    hwc = tuple(cfg["input_hwc"])
    pool = weights.images(2 * 32, hwc, weights.generator(
        seed, weights.POOL, dev), dev).view(2, 32, *hwc)
    kernels = ("sconv_fused", "bsc_spmm", "lrn", "maxpool", "conv_epilogue",
               "stem_conv")
    before = trace.snapshot()["counters"]
    system = PortSystem(cfg, table, params, dev)
    try:
        # the first query captures, the second replays
        kept = [(j, system.query(pool[j])) for j in range(2)]
        after = trace.snapshot()["counters"]
        captured = tuple(after[f"capture.launches.{k}"]
                         - before.get(f"capture.launches.{k}", 0)
                         for k in kernels)
        declared = system.net.launches(system.aligned, {"data": tuple(
            pool[0].shape)}, torch.bfloat16)
        assert captured == tuple(declared[k] for k in kernels) == (
            4, 3, 2, 3, 0, 1), (captured, declared)
        assert after["entry.captures"] - before.get("entry.captures", 0) == 1
        numbers, _ = check.against_reference(table, params, pool, kept, cfg)
        print(f"alexnet b32: launches {dict(zip(kernels, captured))}; "
              f"{numbers}")
        assert numbers["logit_rel_err"] <= cfg["limits"]["logit_rel_err"]
    finally:
        system.close()


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
        launches = n.launches(aligned, shapes)
        expect = {k: launches[k] for k in ("sconv_fused", "sconv_gc",
                                           "bsc_spmm")}
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
    """The packed LRN (the kernel) and the s2d stem's pad and crop build no
    tensor per call: both replay from a CUDA graph and agree with eager."""
    from caffe_escoin_tpu_torch.ops import norm as norm_ops
    from caffe_escoin_tpu_torch.ops import s2d as s2d_ops

    x = torch.randn((2, 14, 14, 64), device=dev).bfloat16()
    img = torch.randn((2, 21, 21, 3), device=dev).bfloat16()

    def fwd():
        return (norm_ops.lrn_across_channels(x, groups=2),
                s2d_ops.s2d_input(img, 2, (2, 2), (0, 0)))

    launches = lrn.launches
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
    assert lrn.launches == launches + 3  # the LRN is the kernel's
    assert captured[1].shape == (2, 10, 10, 12)  # cropped to the conv's 10
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


# the LRN kernel: GoogLeNet's norm1 and norm2 at b32 and b8 and the packed
# norm1 (Caffe's alpha 1e-4, k 1, n 5, activations of scale 30), then the
# grid of groups x local_size x beta on a small map (alpha 1e-2, k 2, scale
# 3), maps whose C is not a multiple of the 16-byte vector, and the
# narrower windows of local_size 3 and 1; name ->
# (shape, groups, local_size, beta, alpha, k, scale)
LRN_CASES = {
    "norm1_b32": ((32, 56, 56, 64), 1, 5, 0.75, 1e-4, 1.0, 30.0),
    "norm2_b32": ((32, 56, 56, 192), 1, 5, 0.75, 1e-4, 1.0, 30.0),
    "norm1_b8": ((8, 56, 56, 64), 1, 5, 0.75, 1e-4, 1.0, 30.0),
    "norm2_b8": ((8, 56, 56, 192), 1, 5, 0.75, 1e-4, 1.0, 30.0),
    "packed_norm1_b8": ((8, 56, 28, 128), 2, 5, 0.75, 1e-4, 1.0, 30.0),
    **{f"g{g}_n{n}_beta{b}": ((2, 9, 7, 48), g, n, b, 1e-2, 2.0, 3.0)
       for g in (1, 2, 4) for n in (5, 4) for b in (0.75, 0.5)},
    "c20": ((3, 5, 7, 20), 1, 5, 0.75, 1e-2, 2.0, 3.0),
    "c20_g2_n4_beta0.5": ((3, 5, 7, 20), 2, 4, 0.5, 1e-2, 2.0, 3.0),
    "c3": ((2, 3, 5, 3), 1, 5, 0.75, 1e-2, 2.0, 3.0),
    "c40_n3": ((2, 4, 4, 40), 1, 3, 0.75, 1e-2, 2.0, 3.0),
    "c72_n1": ((1, 3, 3, 72), 1, 1, 0.75, 1e-3, 2.0, 3.0),
}


def _lrn_case(name, dev, dtype):
    shape, groups, n, beta, alpha, k, scale = LRN_CASES[name]
    g = torch.Generator(device=dev).manual_seed(11)
    x = (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    return x, dict(local_size=n, alpha=alpha, beta=beta, k=k, groups=groups)


def _within_one_bf16_ulp(out, ref):
    """Each |out - ref| at most the bf16 spacing at ref (exact at 0)."""
    out, ref = out.float(), ref.float()
    _, e = torch.frexp(ref)
    ulp = torch.where(ref == 0, torch.zeros_like(ref),
                      torch.ldexp(torch.ones_like(ref), e - 8))
    bad = (out - ref).abs() > ulp
    assert not bad.any(), (int(bad.sum()), out[bad][:4], ref[bad][:4])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(LRN_CASES))
def test_lrn_kernel_matches_plain(dev, name, dtype):
    """The kernel against its plain version on the same card: f32 within
    rtol 1e-5, atol 1e-6; bf16 at most one bf16 ulp apart. One launch a
    call, an f32 one for an f32 map."""
    x, kw = _lrn_case(name, dev, dtype)
    launches, launches_f32 = lrn.launches, lrn.launches_f32
    with torch.inference_mode():
        out = lrn.lrn(x, **kw)
        torch.cuda.synchronize()
        ref = lrn.lrn_plain(x, **kw)
    f32 = dtype == torch.float32
    assert (lrn.launches, lrn.launches_f32) == (launches + 1,
                                                launches_f32 + int(f32))
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.isfinite(out).all()
    if f32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    else:
        _within_one_bf16_ulp(out, ref)


def test_lrn_kernel_copies_a_strided_map_and_refuses_others(dev):
    """A non-contiguous map is copied first; an f16 map and a window
    beyond the kernel's reach raise."""
    x, kw = _lrn_case("g2_n5_beta0.75", dev, torch.bfloat16)
    wide = torch.cat([x, x], dim=-1)[..., 5:53]
    assert not wide.is_contiguous()
    _within_one_bf16_ulp(lrn.lrn(wide, **kw), lrn.lrn_plain(wide, **kw))
    with pytest.raises(TypeError):
        lrn.lrn(x.half(), **kw)
    with pytest.raises(ValueError):
        lrn.lrn(x, local_size=lrn.MAX_LOCAL_SIZE + 1)


def test_lrn_kernel_backward_is_the_plain_gradient(dev):
    """Through the autograd Function: the kernel forward (one launch), the
    plain version's gradient backward, equal to autograd's through the
    plain version."""
    x, kw = _lrn_case("g2_n4_beta0.5", dev, torch.float32)
    g = torch.randn_like(x)
    x.requires_grad_()
    launches = lrn.launches
    y = lrn.lrn(x, **kw)
    (got,) = torch.autograd.grad(y, x, g)
    assert lrn.launches == launches + 1
    xr = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(lrn.lrn_plain(xr, **kw), xr, g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _zoo_max_pools(model, batch):
    """(name, input shape, kernel, stride, padding) of every max pool of
    ``model`` at ``batch``."""
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net

    build, shapes = ZOO[model]
    return [(layer.spec.name, ins[0], *(layer._args()[k] for k in (
        "kernel", "stride", "padding")))
        for layer, ins in Net(build()).walk_shapes(
            {"data": (batch,) + shapes["data"][1:]})
        if layer.spec.type == "Pooling" and layer.p.get("mode", "max") == "max"
        and not layer.p.get("global_pooling", False)]


# the max-pool kernel: name -> (shape, kernel, stride, padding, dtype,
# special values); the benchmark's 19 max pools at b8 and b32 in bf16, three
# of them in f32, C not a multiple of the 16-byte vector, maps of ties, -inf,
# signed zeros and NaN, and windows that take the kernel's other walk
MAXPOOL_CASES = {
    **{f"{m}_{name}_b{b}": (shape, k, s, p, torch.bfloat16, False)
       for m in ("googlenet", "resnet50", "vgg16") for b in (8, 32)
       for name, shape, k, s, p in _zoo_max_pools(m, b)},
    "pool1_b32_f32": ((32, 112, 112, 64), (3, 3), (2, 2), (0, 0),
                      torch.float32, False),
    "inception_3a_b32_f32": ((32, 28, 28, 192), (3, 3), (1, 1), (1, 1),
                             torch.float32, False),
    "vgg_pool1_b8_f32": ((8, 224, 224, 64), (2, 2), (2, 2), (0, 0),
                         torch.float32, False),
    "c20": ((3, 13, 13, 20), (3, 3), (2, 2), (0, 0), torch.bfloat16, False),
    "c20_f32": ((3, 13, 13, 20), (3, 3), (1, 1), (1, 1), torch.float32,
                False),
    "c3": ((2, 9, 9, 3), (3, 3), (1, 1), (1, 1), torch.bfloat16, False),
    "c3_f32": ((2, 9, 9, 3), (2, 2), (2, 2), (0, 0), torch.float32, False),
    "special": ((4, 14, 14, 64), (3, 3), (2, 2), (1, 1), torch.bfloat16,
                True),
    "special_s1": ((4, 14, 14, 64), (3, 3), (1, 1), (1, 1), torch.bfloat16,
                   True),
    "special_f32": ((4, 13, 13, 24), (3, 3), (2, 2), (0, 0), torch.float32,
                    True),
    "spp_4x4_s4_p2": ((2, 13, 13, 256), (4, 4), (4, 4), (2, 2),
                      torch.bfloat16, True),
    "3x2_s2x1": ((2, 11, 10, 40), (3, 2), (2, 1), (1, 0), torch.bfloat16,
                 True),
}


def _maxpool_case(name, dev):
    shape, kernel, stride, padding, dtype, special = MAXPOOL_CASES[name]
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(shape, generator=g, device=dev)
    if special:  # ties, then -inf, +0, -0 and NaN in 5%, 5%, 5%, 2%
        x = torch.round(x * 4) / 4
        pick = torch.rand(shape, generator=g, device=dev)
        x[pick < 0.05] = float("-inf")
        x[(pick >= 0.05) & (pick < 0.1)] = 0.0
        x[(pick >= 0.1) & (pick < 0.15)] = -0.0
        x[(pick >= 0.15) & (pick < 0.17)] = float("nan")
    out_size = tuple(pool_ops._pooled_size(n, k, st, pd, True) for n, k, st,
                     pd in zip(shape[1:3], kernel, stride, padding))
    return x.to(dtype), (kernel, stride, padding, out_size)


def _same_bits(got, want):
    """NaN where ``want`` has NaN, the same bits everywhere else."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])


@pytest.mark.parametrize("name", list(MAXPOOL_CASES))
def test_maxpool_kernel_matches_plain(dev, name):
    """The kernel against its plain version on the same card, bit for bit;
    one launch a call, an f32 one for an f32 map."""
    x, args = _maxpool_case(name, dev)
    launches, launches_f32 = maxpool.launches, maxpool.launches_f32
    with torch.inference_mode():
        out = maxpool.max_pool(x, *args)
        torch.cuda.synchronize()
        ref = maxpool.max_pool_plain(x, *args)
    f32 = x.dtype == torch.float32
    assert (maxpool.launches, maxpool.launches_f32) == (
        launches + 1, launches_f32 + int(f32))
    _same_bits(out, ref)


def test_maxpool_kernel_copies_a_strided_map_and_refuses_others(dev):
    """A strided map (a channel slice, an unaligned view) is copied first;
    f16 and f64 maps raise."""
    x, args = _maxpool_case("special", dev)
    wide = torch.cat([x, x], dim=-1)[..., 8:72]
    assert not wide.is_contiguous()
    _same_bits(maxpool.max_pool(wide, *args),
               maxpool.max_pool_plain(wide, *args))
    shifted = x.reshape(-1)[1:1 + x[1:].numel()].view(x[1:].shape)
    assert shifted.data_ptr() % 16
    _same_bits(maxpool.max_pool(shifted, *args),
               maxpool.max_pool_plain(shifted, *args))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            maxpool.max_pool(x.to(dtype), *args)


@pytest.mark.parametrize("shape", [(0, 14, 14, 64), (4, 14, 14, 0)])
def test_maxpool_kernel_gives_an_empty_map_an_empty_output(dev, shape):
    """No image or no channel: the kernel's path, not the plain version,
    returns the sized empty output and launches nothing."""
    x = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    launches = maxpool.launches
    with torch.inference_mode():
        out = pool_ops.pool2d(x, (3, 3), stride=(2, 2), padding=(1, 1))
    assert maxpool.launches == launches
    assert out.shape == (shape[0], 8, 8, shape[3]) and out.device == x.device
    assert out.dtype == x.dtype


def test_maxpool_kernel_backward_is_the_plain_gradient(dev):
    """Through the autograd Function: the kernel forward (one launch), the
    plain version's gradient backward, equal to autograd's through the
    plain version."""
    x, args = _maxpool_case("c20_f32", dev)
    g = torch.randn((3, 13, 13, 20), device=dev)
    x.requires_grad_()
    launches = maxpool.launches
    y = maxpool.max_pool(x, *args)
    (got,) = torch.autograd.grad(y, x, g)
    assert maxpool.launches == launches + 1
    xr = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(maxpool.max_pool_plain(xr, *args), xr, g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("model,pools", [("googlenet", 13), ("resnet50", 1),
                                         ("vgg16", 5)])
def test_captured_forward_launches_the_maxpool_kernel(dev, model, pools):
    """A CUDA-graph capture of the dense bf16 net at batch 2 counts the
    max-pool launches ``Net.launches`` declares, one a max pool
    (``capture.launches.maxpool``); a profiled eager forward runs the
    kernel and no ``max_pool_forward_nhwc``."""
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
    from caffe_escoin_tpu_torch.utils import trace

    build, shapes = ZOO[model]
    in_shape = (2,) + shapes["data"][1:]
    net = Net(build(), policy=ExecutionPolicy(
        compute_dtype=torch.bfloat16, cast_back=False))
    params = net.init(torch.Generator().manual_seed(0), {"data": in_shape})
    fnet, fparams = fuse_inference(net, params, state=net.state0)
    fparams = params_to(fparams, dev, torch.bfloat16)
    x = {"data": torch.randn(in_shape, device=dev)}
    key = "capture.launches.maxpool"
    before = trace.snapshot()["counters"].get(key, 0)
    fnet.inference_fn(fparams, cuda_graph=True)(x)
    declared = fnet.launches(fparams, {"data": in_shape})["maxpool"]
    assert trace.snapshot()["counters"][key] - before == declared == pools
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fnet.forward(fparams, x)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "max_pool_forward_nhwc" in n], names
    assert [n for n in names if "maxpool_kernel" in n], names


# the dense conv's epilogue (csrc/conv_epilogue.cu) at the cells' dense
# convs: (input NHWC, k, cout, stride, pad, dtype, residual)
EPILOGUE_CASES = {
    # in f32: a bf16 stem runs on csrc/stem_conv.cu, without the epilogue
    "resnet50_conv1_b32": ((32, 224, 224, 3), 7, 64, 2, 3, torch.float32,
                           False),
    "googlenet_3a_5x5_b8": ((8, 28, 28, 16), 5, 32, 1, 2, torch.bfloat16,
                            False),
    "vgg16_conv1_2_b32": ((32, 224, 224, 64), 3, 64, 1, 1, torch.bfloat16,
                          False),
    "f32_3a_3x3_reduce_b8": ((8, 28, 28, 192), 1, 96, 1, 0, torch.float32,
                             False),
    "residual_1x1_b8": ((8, 56, 56, 64), 1, 256, 1, 0, torch.bfloat16, True),
}


def _epilogue_case(name, dev):
    shape, k, cout, stride, pad, dtype, res = EPILOGUE_CASES[name]
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = torch.randn((k, k, shape[3], cout), generator=g, device=dev) * (
        2.0 / (k * k * shape[3])) ** 0.5
    b = torch.randn(cout, generator=g, device=dev) * 0.1
    ho = (shape[1] + 2 * pad - k) // stride + 1
    r = (torch.randn((shape[0], ho, ho, cout), generator=g, device=dev)
         .to(dtype) if res else None)
    return x, w, b, r, dict(stride=(stride, stride), padding=(pad, pad))


def _former_epilogue(out, relu, residual=None):
    """What ``conv2d_dense`` ran after ``F.conv2d`` before the epilogue
    kernel: the residual added in out's dtype, ``torch.relu``, a copy to
    contiguous."""
    if residual is not None:
        out = out + residual.to(out.dtype)
    if relu:
        out = torch.relu(out)
    return out.contiguous()


def _former_dense(x, w, b, r, geo, relu=True):
    """``conv2d_dense`` as it was: ``F.conv2d`` with the bias (cuDNN, then
    ATen's broadcast add), the residual add, ``torch.relu``."""
    import torch.nn.functional as F

    out = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                   b.to(x.dtype), **geo).permute(0, 2, 3, 1)
    return _former_epilogue(out, relu, r)


@pytest.mark.parametrize("name", list(EPILOGUE_CASES))
def test_conv2d_dense_epilogue_matches_the_former_path(dev, name):
    """``conv2d_dense`` on the card (cuDNN without the bias, then one
    launch of the epilogue kernel, an f32 one for an f32 map) is
    ``torch.equal`` to the former ``F.conv2d`` with the bias and
    ``torch.relu``, and has its bits."""
    from caffe_escoin_tpu_torch.kernels import conv_epilogue

    x, w, b, r, geo = _epilogue_case(name, dev)
    launches, launches_f32 = (conv_epilogue.launches,
                              conv_epilogue.launches_f32)
    with torch.inference_mode():
        out = conv_ops.conv2d_dense(x, w, b, relu=True, residual=r, **geo)
        torch.cuda.synchronize()
        ref = _former_dense(x, w, b, r, geo)
    f32 = x.dtype == torch.float32
    assert (conv_epilogue.launches, conv_epilogue.launches_f32) == (
        launches + 1, launches_f32 + int(f32))
    assert out.is_contiguous()
    assert torch.equal(out, ref)
    _same_bits(out, ref)


def test_conv2d_dense_epilogue_reads_a_strided_output(dev):
    """An NCHW-contiguous input gives cuDNN's NCHW output, which the kernel
    reads through its strides into a new NHWC map; a bias-only conv and a
    ReLU-only one launch it too; misaligned operands take its scalar path;
    f16 raises."""
    import torch.nn.functional as F

    from caffe_escoin_tpu_torch.kernels import conv_epilogue

    x, w, b, _, geo = _epilogue_case("googlenet_3a_5x5_b8", dev)
    xn = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not xn.is_contiguous()
    with torch.inference_mode():
        for bias, relu in ((b, True), (b, False), (None, True)):
            launches = conv_epilogue.launches
            out = conv_ops.conv2d_dense(xn, w, bias, relu=relu, **geo)
            assert conv_epilogue.launches == launches + 1
            want = F.conv2d(xn.permute(0, 3, 1, 2), w.to(x.dtype).permute(
                3, 2, 0, 1), None if bias is None else bias.to(x.dtype),
                **geo).permute(0, 2, 3, 1)
            want = _former_epilogue(want, relu)
            assert out.is_contiguous()
            _same_bits(out, want)
        y = torch.randn((4, 6, 6, 24), device=dev).bfloat16()
        shifted = torch.randn(25, device=dev).bfloat16()[1:]
        assert shifted.data_ptr() % 16
        ref = conv_epilogue.epilogue_plain(y, shifted, relu=True)
        _same_bits(conv_epilogue.conv_epilogue(y.clone(), shifted, relu=True),
                   ref)
        with pytest.raises(TypeError):
            conv_epilogue.conv_epilogue(y.half(), None, relu=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias, residual", [(False, False), (True, False),
                                            (True, True)])
def test_conv_epilogue_keeps_signed_zeros_and_nan_as_plain(dev, dtype, bias,
                                                           residual):
    """Over a map of signed zeros, infinities, NaN and tiny values the
    kernel gives the plain version's bits: ``torch.relu``'s sign of a zero
    and its NaN, the adds' rounding. An unaligned C (20) takes the scalar
    path, C = 24 the vector."""
    from caffe_escoin_tpu_torch.kernels import conv_epilogue

    special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                            float("-inf"), 1e-38, -1e-38, -1.5, 2.5, 3e38])
    for c in (20, 24):
        g = torch.Generator(device=dev).manual_seed(c)
        y = torch.randn((3, 5, 7, c), generator=g, device=dev)
        y.view(-1)[:special.numel() * 7] = special.repeat(7).to(dev)
        y = y.to(dtype)
        b = torch.randn(c, generator=g, device=dev).to(dtype) if bias else None
        if bias:
            b[:4] = torch.tensor([-0.0, 0.0, float("nan"), 1.0])
        r = (torch.randn((3, 5, 7, c), generator=g, device=dev).to(dtype)
             if residual else None)
        with torch.inference_mode():
            want = conv_epilogue.epilogue_plain(y, b, relu=True, residual=r)
            launches = conv_epilogue.launches
            got = conv_epilogue.conv_epilogue(y.clone(), b, relu=True,
                                              residual=r)
            torch.cuda.synchronize()
        assert conv_epilogue.launches == launches + 1
        _same_bits(got, want)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("model, dense", [("resnet50", 2), ("googlenet", 10)])
def test_captured_forward_launches_the_conv_epilogue(dev, model, dense):
    """The configuration's net (convs with Cin >= 32 pruned to 90% of their
    128x128 blocks, fused, bf16, the kernel routes) at batch 2, captured:
    ``capture.launches.conv_epilogue`` and ``capture.launches.stem_conv``
    count what ``Net.launches`` declares, the stem on the stem kernel and
    one epilogue each other dense conv; a profiled eager forward runs both
    kernels and neither cuDNN's CUDA-core direct conv nor its channel
    pad."""
    from caffe_escoin_tpu_torch.engine.context import ConvMode
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
    from caffe_escoin_tpu_torch.utils import trace

    build, shapes = ZOO[model]
    in_shape = {"data": (2,) + shapes["data"][1:]}
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(128, 128),
                          compute_dtype=torch.bfloat16, cast_back=False,
                          use_xla_sparse=False)
    net = Net(build(), policy=pol)
    params = net.init(torch.Generator().manual_seed(0), in_shape)
    for layer in net.layers:
        p = params.get(layer.spec.name)
        if (layer.spec.type in ("Convolution", "ConvolutionReLU")
                and p["w"].shape[2] >= 32):
            p["w"] = torch.from_numpy(prune_conv_weight(
                p["w"].numpy(), 0.9, (128, 128)))
    fnet, fparams = fuse_inference(net, params, state=net.state0)
    aligned = params_to(fnet.weight_align(fparams), dev, torch.bfloat16)
    x = {"data": torch.randn(in_shape["data"], device=dev)}
    keys = ("capture.launches.conv_epilogue", "capture.launches.stem_conv")
    before = [trace.snapshot()["counters"].get(k, 0) for k in keys]
    fnet.inference_fn(aligned, cuda_graph=True)(x)
    declared = fnet.launches(aligned, in_shape)
    assert [trace.snapshot()["counters"][k] - b
            for k, b in zip(keys, before)] == [
        declared["conv_epilogue"], declared["stem_conv"]] == [dense - 1, 1]
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fnet.forward(aligned, x)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert [n for n in names if "conv_epilogue_kernel" in n], names
    assert [n for n in names if "stem_conv_kernel" in n], names
    assert not [n for n in names if "convolve_common_engine" in n
                or "nhwcAddPadding" in n], names


# the stem conv (csrc/stem_conv.cu): (n, h, w, cin, k, stride, pad, cout);
# AlexNet's conv1 leaves a last tile of 209 of 256 pixels an image
STEM_CASES = {
    "alexnet_conv1_b1": (1, 227, 227, 3, 11, 4, 0, 96),
    "alexnet_conv1_b32": (32, 227, 227, 3, 11, 4, 0, 96),
    "resnet50_conv1_b1": (1, 224, 224, 3, 7, 2, 3, 64),
    "resnet50_conv1_b32": (32, 224, 224, 3, 7, 2, 3, 64),
    "googlenet_conv1_b8": (8, 224, 224, 3, 7, 2, 3, 64),
    "vgg16_conv1_1_b1": (1, 224, 224, 3, 3, 1, 1, 64),
    "vgg16_conv1_1_b32": (32, 224, 224, 3, 3, 1, 1, 64),
    "ragged_7x7_c1_cout40": (3, 101, 87, 1, 7, 2, 3, 40),
    "ragged_5x5_c4_cout128": (2, 61, 75, 4, 5, 3, 2, 128),
}


def _stem_case(name, dev):
    n, h, w, c, k, s, p, cout = STEM_CASES[name]
    g = torch.Generator(device=dev).manual_seed(len(name))
    x = torch.randn((n, h, w, c), generator=g, device=dev).bfloat16()
    wt = (torch.randn((k, k, c, cout), generator=g, device=dev)
          * (2.0 / (k * k * c)) ** 0.5).bfloat16()
    b = torch.randn(cout, generator=g, device=dev) * 0.1
    return x, wt, b, dict(stride=(s, s), padding=(p, p))


def _stem_reference(x, wt, b, geo):
    """The conv of the same bf16 values in f32 (TF32 off), + bias, ReLU."""
    import torch.nn.functional as F

    return torch.relu(F.conv2d(x.float().permute(0, 3, 1, 2),
                               wt.float().permute(3, 2, 0, 1), b.float(),
                               **geo).permute(0, 2, 3, 1))


@pytest.mark.parametrize("name", list(STEM_CASES))
def test_stem_conv_kernel_matches_plain(dev, name):
    """One launch a call, through ``conv2d_dense``; the weight laid out
    once into the memo; the same bits on a second call; within the bf16
    rule of the plain version, and within one bf16 rounding of each output
    of the f32 conv (the kernel sums in f32 and rounds once)."""
    from caffe_escoin_tpu_torch.kernels import stem_conv

    x, wt, b, geo = _stem_case(name, dev)
    memo = {}
    with torch.inference_mode():
        assert conv_ops.runs_stem(x, wt, b, **geo)
        launches = stem_conv.launches
        out = conv_ops.conv2d_dense(x, wt, b, relu=True, memo=memo, **geo)
        torch.cuda.synchronize()
        assert stem_conv.launches == launches + 1 and len(memo) == 1
        again = conv_ops.conv2d_dense(x, wt, b, relu=True, memo=memo, **geo)
        plain = stem_conv.stem_plain(x, wt, b, relu=True, **geo)
        ref = _stem_reference(x, wt, b, geo)
    assert len(memo) == 1 and out.is_contiguous()
    assert out.shape == plain.shape and torch.equal(out, again)
    _close(out, plain, torch.bfloat16)
    err = (out.float() - ref).abs()
    bound = 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()
    assert (err <= bound).all(), (err - bound).max().item()


def test_stem_conv_keeps_a_nan_inside_its_windows(dev):
    """A NaN pixel in each corner of an image: the outputs whose windows
    hold it are NaN (ReLU keeps a NaN), every other output is finite; the
    masked last K step and the zeroed padding never read it elsewhere."""
    from caffe_escoin_tpu_torch.kernels import stem_conv

    for name in ("alexnet_conv1_b1", "resnet50_conv1_b1",
                 "ragged_7x7_c1_cout40"):
        x, wt, b, geo = _stem_case(name, dev)
        x[0, 0, 0, :] = float("nan")
        x[-1, -1, -1, -1] = float("nan")
        with torch.inference_mode():
            out = stem_conv.stem_conv(x, wt, b, relu=True, **geo)
            ref = _stem_reference(x, wt, b, geo)
        assert torch.equal(torch.isnan(out), torch.isnan(ref)), name
        assert torch.isnan(ref).any()


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
    launches = net.launches(aligned, shapes)
    expect = {k: launches[k] for k in ("sconv_fused", "bsc_spmm", "sconv_gc")}
    assert expect == {"sconv_fused": 4, "bsc_spmm": 3, "sconv_gc": 0}, routes
    _, (ted, tel) = load_digits_upscaled(227, 3)
    for m in (sconv_fused, bsc_spmm, sconv_gc):
        m.reset_counts()
    acc = evaluate(net, aligned, {}, ted[:64], tel[:64])
    torch.cuda.synchronize()
    assert 0.0 <= acc <= 1.0
    assert {"sconv_fused": sconv_fused.launches, "bsc_spmm": bsc_spmm.launches,
            "sconv_gc": sconv_gc.launches} == expect


@pytest.mark.parametrize("xla", [True, False], ids=["xbsp", "kernel"])
def test_weights_as_args_graph_is_bit_identical_on_resnet50_b8(dev, xla):
    """ResNet-50 b8 as the probes build it (90% in 128x128 blocks, fused,
    aligned, bf16; the default XBSP executor or the kernel routes): the
    graph-replay forward over grafted payloads
    (``inference_fn(cuda_graph=True, weights_as_args=True)``) gives the
    closed-over graph's output bit for bit, on two inputs."""
    import dataclasses

    from caffe_escoin_tpu_torch.experiments import common
    from caffe_escoin_tpu_torch.nn import Net

    s = common.sparse_net("resnet50", 8, dev, autotune=False)
    net = Net(s.net.specs, policy=dataclasses.replace(
        s.net.policy, use_xla_sparse=xla))
    closed = net.inference_fn(s.aligned, cuda_graph=True)
    as_args = net.inference_fn(s.aligned, cuda_graph=True,
                               weights_as_args=True)
    for m in (sconv_fused, bsc_spmm, sconv_gc):
        m.reset_counts()
    for x in s.xs[:2] * 2:  # eager + capture, then replays
        want = closed({"data": x})["prob"].clone()
        got = as_args({"data": x})["prob"]
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)
    assert bool(sconv_fused.launches) == (not xla)


@pytest.mark.parametrize("hw", [56, 7])
def test_k3_fused_arm_launches_sconv_fused(dev, hw):
    """The k3 probe's ``fused_cuda`` arm is the hand kernel (one launch a
    call) and meets the f32 dense conv of the pruned weight within phase
    3's rule."""
    from caffe_escoin_tpu_torch.experiments import k3

    arms = k3.arms_of(hw, dev, batch=8, sparsity=0.9, arms={"fused"},
                      rng=np.random.default_rng(0))
    assert [a[1] for a in arms] == ["fused_cuda"]
    _, _, fn, ref, sets, _, _ = arms[0]
    sconv_fused.reset_counts()
    got = fn(*sets[0]).float()
    torch.cuda.synchronize()
    assert sconv_fused.launches == 1
    want = ref(*sets[0])
    err = (got - want).abs().max().item()
    assert err <= 1e-2 * want.abs().max().item() + 1e-2
