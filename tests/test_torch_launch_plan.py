"""The launch plans of the two direct sparse convs (kernels/sconv_pipe.py),
checked on the CPU for every conv that takes the fused or the
garbage-column route in VGG-16 at b16 and ResNet-50 at b32 (224x224,
weights pruned to 90% in 128x128 blocks, bf16 activations): routes from
``Net.routes``, shapes from ``Net.walk_shapes``, the plan from each
wrapper's ``launch_plan``, as ``sconv`` passes it to the kernel.

Each plan must fit the shared memory one block may use on an H100, its grid
must cover every output row and block-column exactly once, and a
garbage-column tile must never cross an image. Also on the CPU: the
kernel route's operands (its one-write slab, its re-blocking of x and the
weight where Cin or bk is not a multiple of 8) compute the same conv.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import sconv_fused, sconv_gc, sconv_pipe
from caffe_escoin_tpu_torch.models import ZOO
from caffe_escoin_tpu_torch.nn import Net
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

BLOCK = (128, 128)
SPARSITY = 0.9
BATCH = {"vgg16": 16, "resnet50": 32}
WRAPPERS = {"fused": sconv_fused, "gc": sconv_gc}


@pytest.fixture(scope="module", params=list(BATCH))
def layers(request):
    """(name, route, x shape after any 1x1 subsample, padding, aligned) of
    every conv that takes a direct route."""
    model = request.param
    build, shapes = ZOO[model]
    shapes = {"data": (BATCH[model],) + tuple(shapes["data"][1:])}
    policy = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                             compute_dtype=torch.bfloat16, cast_back=False,
                             use_xla_sparse=False)
    net = Net(build(), policy=policy)
    rng = np.random.default_rng(0)
    aligned, convs = {}, {}
    for layer, in_shapes in net.walk_shapes(shapes):
        spec = layer.spec
        if spec.type not in ("Convolution", "ConvolutionReLU"):
            continue
        p = spec.params
        k, cin = p["kernel"], in_shapes[0][-1]
        w = rng.standard_normal((k, k, cin, p["num_output"])).astype(
            np.float32)
        if cin >= 32:
            w = prune_conv_weight(w, SPARSITY, BLOCK)
        aligned[spec.name] = weight_align(w, policy=policy)
        n, h, wd, c = in_shapes[0]
        s, pad = p.get("stride", 1), p.get("pad", 0)
        if s != 1 and k == 1:  # runs on the subsampled map
            h, wd = (h + 2 * pad - 1) // s + 1, (wd + 2 * pad - 1) // s + 1
            pad = 0
        convs[spec.name] = ((n, h, wd, c), (pad, pad))
    routes = net.routes(aligned, shapes)
    out = [(name, routes[name], *convs[name], aligned[name])
           for name in convs if routes[name] in WRAPPERS]
    assert len(out) == {"vgg16": 11, "resnet50": 51}[model]
    return model, out


def _plan(route, x_shape, padding, al):
    return WRAPPERS[route].launch_plan(x_shape, al, padding)


def test_plan_fits_shared_memory(layers):
    _, convs = layers
    for name, route, x_shape, padding, al in convs:
        p = _plan(route, x_shape, padding, al)
        bn_t = sconv_pipe.bn_tile(al.bsc.block_shape[1])
        assert p.smem == sconv_pipe.smem_bytes(p.tile_m, bn_t, p.stages)
        assert p.smem <= sconv_pipe.SMEM_PER_BLOCK, name
        # two blocks per SM, as the ring depth was chosen for
        assert 2 * (p.smem + sconv_pipe.SMEM_RESERVED) <= \
            sconv_pipe.SMEM_PER_SM, name
        assert p.tile_m in (64, 128) and 2 <= p.stages <= 4
        assert p.chunk == sconv_pipe.CHUNK and p.threads == 2 * p.tile_m


def _out_rows(route, p, x_shape, padding, al, b):
    """The output rows [N*Ho*Wo] that grid block ``b`` writes, as the
    kernel's Rows policy maps its tile rows (ConvRows / SlabRows.out_row)."""
    img, first, end, _ = p.block(b)
    rows = np.arange(first, end)
    if route == "fused":
        return rows
    kh, kw = al.kernel_shape
    n, h, w, _ = x_shape
    ho, wp = h + 2 * padding[0] - kh + 1, w + 2 * padding[1]
    wo = wp - kw + 1
    hh, ww = rows // wp, rows % wp
    keep = ww < wo
    return (img * ho + hh[keep]) * wo + ww[keep]


def test_grid_covers_every_output_row_and_block_column(layers):
    _, convs = layers
    for name, route, x_shape, padding, al in convs:
        p = _plan(route, x_shape, padding, al)
        kh, kw = al.kernel_shape
        n, h, w, _ = x_shape
        m = n * (h + 2 * padding[0] - kh + 1) * (w + 2 * padding[1] - kw + 1)
        assert p.n_bcols == al.bsc.n_bcols
        assert p.n_bcols * al.bsc.block_shape[1] >= al.cout
        seen = np.zeros((m, p.n_bcols), np.int32)
        for b in range(p.grid):
            rows = _out_rows(route, p, x_shape, padding, al, b)
            seen[rows, p.block(b)[3]] += 1
        assert (seen == 1).all(), name


def test_gc_tile_never_crosses_an_image(layers):
    model, convs = layers
    gc = [c for c in convs if c[1] == "gc"]
    assert len(gc) == (4 if model == "vgg16" else 0)
    for name, _, x_shape, padding, al in gc:
        p = _plan("gc", x_shape, padding, al)
        kh, _ = al.kernel_shape
        n, h, w, _ = x_shape
        assert p.images == n
        assert p.rows_per_image == (h + 2 * padding[0] - kh + 1) * (
            w + 2 * padding[1])
        for b in range(p.grid):
            img, first, end, _ = p.block(b)
            assert 0 <= img < n and 0 <= first < end <= p.rows_per_image


def test_block_columns_of_a_tile_launch_side_by_side(layers):
    _, convs = layers
    for name, route, x_shape, padding, al in convs:
        p = _plan(route, x_shape, padding, al)
        for b in range(0, p.grid, p.n_bcols):
            tiles = {p.block(b + j)[:3] for j in range(p.n_bcols)}
            assert len(tiles) == 1, name


def test_kernel_arguments_carry_the_launch_plan(layers):
    """The integer array ``sconv`` hands the C entry holds ``launch_plan``'s
    plan and the row count its grid was planned for. Built on meta tensors:
    the operands' shapes, not their data."""
    _, convs = layers
    for name, route, x_shape, padding, al in convs:
        p = _plan(route, x_shape, padding, al)
        x = torch.empty(x_shape, dtype=torch.bfloat16, device="meta")
        xk, _, bk = sconv_pipe.kernel_operands(x, al)
        if route == "fused":
            d = list(sconv_fused._dims(x_shape, xk.shape[-1], bk, al,
                                       padding, True, True))
            assert d[0] * d[4] * d[5] == p.images * p.rows_per_image, name
        else:
            n_cin_b = al.cin_pad // al.bsc.block_shape[0]
            slab = sconv_gc._kernel_slab(xk, padding, n_cin_b * bk)
            d = list(sconv_gc._dims(x_shape, slab.shape, bk, al, padding,
                                    True, True))
            assert (d[0], d[3] * d[5]) == (p.images, p.rows_per_image), name
        assert d[-4:] == [p.tile_m, p.stages, p.chunk, p.smem], name


def test_tile_rows_follow_the_number_of_blocks(layers):
    """128-row tiles where they give every other SM a block, 64 below."""
    model, convs = layers
    for name, route, x_shape, padding, al in convs:
        p = _plan(route, x_shape, padding, al)
        big = p.images * -(-p.rows_per_image // 128) * p.n_bcols
        assert p.tile_m == (128 if big >= sconv_pipe.SMS // 2 else 64), name
    tiles = {name: _plan(r, x, pad, al).tile_m
             for name, r, x, pad, al in convs}
    if model == "resnet50":
        assert tiles["res2a_branch2b"] == 128
        assert tiles["res4a_branch2b"] == 128
        assert tiles["res5a_branch2b"] == 64
    else:
        assert tiles["conv2_2"] == 128 and tiles["conv5_2"] == 128


@pytest.mark.parametrize("shape", [(2, 7, 9, 64, 3, 1), (3, 5, 6, 40, 3, 1),
                                   (1, 6, 5, 24, 5, 2), (2, 4, 4, 16, 1, 0)])
def test_kernel_slab_is_the_plain_slab_in_one_write(shape):
    n, h, w, cin, k, pad = shape
    rng = np.random.default_rng(3)
    wt = prune_conv_weight(rng.standard_normal((k, k, cin, 16)).astype(
        np.float32), 0.6, (8, 8))
    al = weight_align(wt, policy=ExecutionPolicy(block_shape=(8, 8)))
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(
        np.float32))
    g = sconv_gc._geometry(x.shape, al.kernel_shape, (pad, pad))
    plain = sconv_gc._slab(x, al, (pad, pad), g)
    xk, _, bk = sconv_pipe.kernel_operands(x, al)
    slab = sconv_gc._kernel_slab(xk, (pad, pad), al.cin_pad)
    assert slab.dtype == torch.bfloat16 and slab.is_contiguous()
    assert slab.shape[1] >= plain.shape[1]
    assert torch.equal(slab[:, :plain.shape[1]], plain.bfloat16())
    assert not slab[:, plain.shape[1]:].any()


@pytest.mark.parametrize("cin,block", [(30, (128, 128)), (30, (12, 16)),
                                       (20, (16, 16)), (64, (64, 64))])
def test_kernel_operands_compute_the_same_conv(cin, block):
    """x and the blocks as the kernels copy them (bf16, channels and bk
    padded to multiples of 8) give the conv of the unpadded operands."""
    rng = np.random.default_rng(4)
    wt = prune_conv_weight(rng.standard_normal((3, 3, cin, 24)).astype(
        np.float32), 0.8, (min(block[0], cin), block[1]))
    al = weight_align(wt, policy=ExecutionPolicy(block_shape=block))
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, cin)).astype(
        np.float32)).bfloat16()
    xk, blocks, bk = sconv_pipe.kernel_operands(x, al)
    assert xk.dtype == blocks.dtype == torch.bfloat16
    assert xk.shape[-1] % 8 == 0 and bk % 8 == 0 and blocks.shape[2] == bk
    bsc = al.bsc
    n_cin_b = al.cin_pad // bsc.block_shape[0]
    assert xk.shape[-1] <= n_cin_b * bk
    wk = dataclasses.replace(
        bsc, blocks=blocks, shape=(9 * n_cin_b * bk, bsc.shape[1]),
        block_shape=(bk, bsc.block_shape[1])).to_dense().float()
    wk = wk.reshape(3, 3, n_cin_b * bk, al.cout)[:, :, :xk.shape[-1]]
    w = bsc.to_dense().bfloat16().float().reshape(
        3, 3, al.cin_pad, al.cout)[:, :, :cin]

    def conv(a, wt_):
        return F.conv2d(a.float().permute(0, 3, 1, 2), wt_.permute(3, 2, 0, 1),
                        padding=1)

    torch.testing.assert_close(conv(xk, wk), conv(x, w), rtol=1e-5,
                               atol=1e-5)
