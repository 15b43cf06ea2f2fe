"""The launch plan of the SpMM kernel (``sconv_pipe.spmm_plan``, reached
through ``bsc_spmm.launch_plan``), checked on the CPU at the shapes its
callers give it: ResNet-50's fc1000 at b32, VGG-16's fc6-8 at b16 and
conv1_2's lowered im2col GEMM at b16 (90% block sparsity), AlexNet's
fc6-8 and GoogLeNet's classifier at b32, and 1x1 convs of ResNet-50 at b32
as the ``spmm_1x1`` route would hand them over.

Each plan must fit the shared memory one block may use on an H100, its grid
must cover every (row, block-column), every live slot of every column must
fall in exactly one share of a split launch, and only launches too small
to fill the card may split. Also on the CPU: the operands as the kernel
copies them (``bsc_spmm.kernel_operands``) give the same product, and on
the main path they are the caller's tensors, not copies.

The fc weights' live blocks are drawn as ``prune_blocks`` keeps them from a
Gaussian weight (a uniform 10% of the blocks), without the dense weight:
the plan reads only the BSC's shapes and counts.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_pipe
from caffe_escoin_tpu_torch.sparse import dense_to_bsc
from caffe_escoin_tpu_torch.sparse.formats import BSC
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
from caffe_escoin_tpu_torch.utils.pruning import prune_blocks, prune_conv_weight

SPARSITY = 0.9
BLOCK = (128, 128)


def _fc_bsc(k, n, seed):
    """A BSC of W[k, n] in 128x128 blocks with a uniform 10% of its blocks
    live; payloads on the meta device (only their shape is read)."""
    bk, bn = BLOCK
    nbr, nbc = -(-k // bk), -(-n // bn)
    live = np.zeros(nbr * nbc, bool)
    keep = nbr * nbc - int(round(nbr * nbc * SPARSITY))
    live[np.random.default_rng(seed).permutation(nbr * nbc)[:keep]] = True
    live = live.reshape(nbr, nbc)
    nnz = live.sum(axis=0).astype(np.int32)
    max_bw = max(1, int(nnz.max()))
    block_row = np.zeros((nbc, max_bw), np.int32)
    for j in range(nbc):
        rows = np.nonzero(live[:, j])[0]
        block_row[j, :len(rows)] = rows
    return BSC(blocks=torch.empty((nbc, max_bw, bk, bn), device="meta"),
               block_row=torch.from_numpy(block_row),
               bcol_nnz=torch.from_numpy(nnz), shape=(k, n),
               block_shape=BLOCK, nnz_blocks=int(nnz.sum()))


def _conv_bsc(k, cin, cout, seed):
    """The GEMM-view BSC of a k x k conv pruned as chip_smoke.py prunes it."""
    rng = np.random.default_rng(seed)
    w = prune_conv_weight(
        rng.standard_normal((k, k, cin, cout)).astype(np.float32), SPARSITY,
        (min(128, cin), 128))
    return weight_align(w, policy=ExecutionPolicy(block_shape=BLOCK)).bsc


# name -> (M, BSC factory)
SHAPES = {
    "fc1000 b32": (32, lambda: _fc_bsc(2048, 1000, 0)),
    "fc6 b16": (16, lambda: _fc_bsc(25088, 4096, 1)),
    "fc7 b16": (16, lambda: _fc_bsc(4096, 4096, 2)),
    "fc8 b16": (16, lambda: _fc_bsc(4096, 1000, 3)),
    "alexnet fc6 b32": (32, lambda: _fc_bsc(9216, 4096, 8)),
    "alexnet fc7 b32": (32, lambda: _fc_bsc(4096, 4096, 9)),
    "alexnet fc8 b32": (32, lambda: _fc_bsc(4096, 1000, 10)),
    "googlenet loss3/classifier b32": (32, lambda: _fc_bsc(1024, 1000, 11)),
    "conv1_2 lowered b16": (16 * 224 * 224, lambda: _conv_bsc(3, 64, 64, 4)),
    "res2 1x1 64->256 b32": (32 * 56 * 56, lambda: _conv_bsc(1, 64, 256, 5)),
    "res3 1x1 512->128 b32": (32 * 28 * 28,
                              lambda: _conv_bsc(1, 512, 128, 6)),
    "res4 1x1 1024->256 b32": (32 * 14 * 14,
                               lambda: _conv_bsc(1, 1024, 256, 7)),
}
LARGE_M = [name for name, (m, _) in SHAPES.items() if m > 1000]


@functools.lru_cache(maxsize=None)
def _case(name):
    m, make = SHAPES[name]
    bsc = make()
    return m, bsc, bsc_spmm.launch_plan(m, bsc)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_fits_shared_memory(name):
    m, bsc, p = _case(name)
    bk, bn = bsc.block_shape
    bn_t = sconv_pipe.bn_tile(bn)
    assert p.smem == sconv_pipe.smem_bytes(p.tile_m, bn_t, p.stages)
    assert p.smem <= sconv_pipe.SMEM_PER_BLOCK
    # two blocks per SM, as the ring depth was chosen for
    assert 2 * (p.smem + sconv_pipe.SMEM_RESERVED) <= sconv_pipe.SMEM_PER_SM
    assert p.tile_m in (64, 128) and 2 <= p.stages <= 4
    assert p.chunk == sconv_pipe.CHUNK and p.threads == 2 * p.tile_m
    assert p.images == 1 and p.rows_per_image == m
    assert p.n_bcols == bsc.n_bcols and p.n_bcols * bn >= bsc.shape[1]
    if m <= 64:
        assert p.tile_m == 64


@pytest.mark.parametrize("name", list(SHAPES))
def test_grid_covers_every_row_and_block_column(name):
    """Every (row, block-column) lies in one tile of each of its ``split``
    shares, and share 0, which always runs (so even an empty column gets
    its epilogue), covers it exactly once."""
    m, bsc, p = _case(name)
    seen = np.zeros((m, p.n_bcols), np.int32)
    first_share = np.zeros((m, p.n_bcols), np.int32)
    for b in range(p.grid):
        img, first, end, j = p.block(b)
        assert img == 0 and 0 <= first < end <= m
        seen[first:end, j] += 1
        if b // p.n_bcols % p.split == 0:
            first_share[first:end, j] += 1
    assert (seen == p.split).all()
    assert (first_share == 1).all()


@pytest.mark.parametrize("name", list(SHAPES))
def test_every_live_slot_falls_in_exactly_one_share(name):
    """Over the ``split`` blocks of one (M-tile, column), the shares walk
    each of the column's live slots once; a block whose share starts past
    the column's end is one the kernel exits at once; and a share keeps at
    least two ring steps."""
    m, bsc, p = _case(name)
    nnz = bsc.bcol_nnz.tolist()
    walked = {}
    for b in range(p.grid):
        mt = b // p.n_bcols // p.split
        j, s = b % p.n_bcols, b // p.n_bcols % p.split
        slots = p.slots(b, nnz[j])
        exits = s > 0 and s * max(p.share, 1) >= nnz[j]  # the kernel's test
        assert exits == (len(slots) == 0 and s > 0), (b, slots)
        walked.setdefault((mt, j), []).extend(slots)
    for (mt, j), slots in walked.items():
        assert sorted(slots) == list(range(nnz[j])), (mt, j)
    if p.split > 1:
        cpb = -(-(bsc.block_shape[0] + -bsc.block_shape[0] % 8) // p.chunk)
        assert p.share * cpb >= 2
        assert (p.split - 1) * p.share < bsc.max_bw <= p.split * p.share


@pytest.mark.parametrize("name", list(SHAPES))
def test_only_launches_too_small_for_the_card_split(name):
    """The fc layers split to about three blocks per SM, where a column has
    more than one live K-block; the large-M callers (the lowered and 1x1
    conv routes) already fill the card and do not."""
    m, bsc, p = _case(name)
    if name in LARGE_M:
        assert p.split == 1 and p.grid >= sconv_pipe.SMS // 2
        return
    assert p.tile_m == 64
    if bsc.max_bw == 1:
        # one live K-block per column at most (GoogLeNet's 1024 -> 1000
        # keeps 6 of its 64 blocks): nothing to cut
        assert p.split == 1 and name.startswith("googlenet")
        return
    assert p.split > 1
    assert p.grid <= 3 * sconv_pipe.SMS
    if name.startswith("fc6"):  # 32 columns of up to ~30 live K-blocks
        assert p.split >= 8 and p.grid >= 2 * sconv_pipe.SMS


@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_arguments_carry_the_launch_plan(name):
    """The integer array ``bsc_spmm`` hands the C entry holds the shape,
    ``launch_plan``'s plan and the counter buffer's length."""
    m, bsc, p = _case(name)
    bk, bn = bsc.block_shape
    k = bsc.shape[0]
    plan, dims = bsc_spmm._launch(m, k + -k % 8, bsc.shape[1], bk + -bk % 8,
                                  bn, bsc.n_bcols, bsc.max_bw, 1, 1)
    assert plan == p
    assert list(dims) == [m, k + -k % 8, bsc.shape[1], bk + -bk % 8, bn,
                          bsc.n_bcols, bsc.max_bw, 1, 1, p.tile_m, p.stages,
                          p.chunk, p.smem, p.split, p.share,
                          bsc_spmm.N_COUNTERS]
    if p.split > 1:
        assert p.m_tiles * p.n_bcols <= bsc_spmm.N_COUNTERS


@pytest.mark.parametrize("k,block,dtype", [
    (203, (64, 64), torch.bfloat16),   # K not a multiple of 8
    (100, (12, 16), torch.bfloat16),   # bk not a multiple of 8
    (90, (20, 24), torch.float32),     # both, and an f32 A
    (256, (64, 32), torch.float32),    # f32 A, nothing to pad
])
def test_kernel_operands_compute_the_same_product(k, block, dtype):
    """A and the blocks as the kernel copies them (bf16, K and bk padded to
    multiples of 8) give the product of the unpadded operands."""
    rng = np.random.default_rng(8)
    n = 40
    w = prune_blocks(rng.standard_normal((k, n)).astype(np.float32), 0.5,
                     block)
    bsc = dense_to_bsc(w, block)
    a = torch.from_numpy(rng.standard_normal((7, k)).astype(np.float32)).to(
        dtype)
    ak, blocks, bk = bsc_spmm.kernel_operands(a, bsc)
    assert ak.dtype == blocks.dtype == torch.bfloat16
    assert ak.is_contiguous() and blocks.is_contiguous()
    assert ak.shape[1] % 8 == 0 and bk % 8 == 0 and blocks.shape[2] == bk
    assert ak.shape[1] <= bsc.n_brows * bk
    wk = dataclasses.replace(bsc, blocks=blocks, shape=(ak.shape[1], n),
                             block_shape=(bk, block[1])).to_dense().float()
    ref = a.bfloat16().float() @ torch.from_numpy(w).bfloat16().float()
    torch.testing.assert_close(ak.float() @ wk, ref, rtol=1e-5, atol=1e-5)
    assert bsc_spmm.launch_plan(7, bsc) == sconv_pipe.spmm_plan(
        7, (bk, block[1]), bsc.n_bcols, bsc.max_bw)


@pytest.mark.parametrize("k,block", [(2048, (128, 128)), (576, (64, 64)),
                                     (200, (64, 64))])
def test_kernel_operands_copy_nothing_on_the_main_path(k, block):
    """bf16 A with K and bk multiples of 8, bf16 payloads: the kernel gets
    the caller's tensors themselves."""
    rng = np.random.default_rng(9)
    w = prune_blocks(rng.standard_normal((k, 64)).astype(np.float32), 0.5,
                     block)
    bsc = dense_to_bsc(w, block).to(dtype=torch.bfloat16)
    a = torch.from_numpy(rng.standard_normal((5, k)).astype(np.float32)
                         ).bfloat16()
    ak, blocks, bk = bsc_spmm.kernel_operands(a, bsc)
    assert ak is a and blocks is bsc.blocks and bk == block[0]
