"""The FLOP and byte counts, the bound and the pruning rule, against
values worked by hand."""

import torch

from portbench import counts, weights

PEAK = {"bf16_flop_s": 989e12, "hbm_byte_s": 3.35e12}


def test_conv_3x3():
    # b2, 8x8x16 -> 8x8x32, 3x3 pad 1, 100 live weights
    work = counts.layer_work("conv", (2, 8, 8, 16), (2, 8, 8, 32), 100,
                             residual=False)
    # 2 * (2*8*8 positions) * 100
    assert work["flops"] == 2 * 128 * 100 == 25600
    # (input 2048 + weights 100 + output 4096) elements, 2 bytes each
    assert work["bytes"] == 2 * (2048 + 100 + 4096) == 12488


def test_conv_1x1_with_residual():
    # b1, 7x7x512 -> 7x7x2048, 1x1, 10% of 512*2048 live, adds a residual
    nnz = 104858
    work = counts.layer_work("conv", (1, 7, 7, 512), (1, 7, 7, 2048), nnz,
                             residual=True)
    assert work["flops"] == 2 * 49 * nnz
    assert work["bytes"] == 2 * (25088 + nnz + 100352 + 100352)


def test_fc_and_bound():
    work = counts.layer_work("fc", (32, 2048), (32, 1000), 1000, False)
    assert work["flops"] == 2 * 32 * 1000
    assert work["bytes"] == 2 * (65536 + 1000 + 32000)
    # memory-bound: bytes / 3.35 TB/s
    assert counts.bound_s(work, PEAK) == work["bytes"] / 3.35e12
    big = {"flops": 989e12, "bytes": 1.0}
    assert counts.bound_s(big, PEAK) == 1.0


def test_peaks_table():
    assert counts.peaks("NVIDIA H100 80GB HBM3") == PEAK
    assert counts.peaks("cpu") is None


def test_prune_blocks_by_hand():
    # one plane 4x4 in 2x2 blocks with norms 1, 2, 3, 4: half pruned
    w = torch.zeros(1, 4, 4)
    w[0, :2, :2] = 0.5       # norm 1
    w[0, :2, 2:] = 1.0       # norm 2
    w[0, 2:, :2] = 1.5       # norm 3
    w[0, 2:, 2:] = 2.0       # norm 4
    out = weights.prune_blocks(w, 0.5, (2, 2), keep_one=True)
    assert out[0, :2].abs().sum() == 0
    assert torch.equal(out[0, 2:], w[0, 2:])
    # a conv keeps a block even at 100%
    one = weights.prune_blocks(w, 0.99, (2, 2), keep_one=True)
    assert torch.equal(one[0, 2:, 2:], w[0, 2:, 2:])
    assert one.count_nonzero() == 4
    assert weights.prune_blocks(w, 1.0, (2, 2), keep_one=False).sum() == 0


def test_prune_ranks_offsets_together_and_pads_edges():
    # 2 offsets of a 3x3 (cin 3, cout 3) plane, blocks of 2: 2x2 blocks
    # per offset, the edge ones padded; 8 blocks, 75% pruned -> 2 kept
    torch.manual_seed(0)
    w = torch.rand(2, 3, 3) + 0.1
    w[1, 2:, 2:] = 100.0     # the padded corner block of offset 1
    w[0, :2, :2] = 50.0      # the full block of offset 0
    out = weights.prune_blocks(w, 0.75, (2, 2), keep_one=True)
    assert torch.equal(out[1, 2:, 2:], w[1, 2:, 2:])
    assert torch.equal(out[0, :2, :2], w[0, :2, :2])
    assert out.count_nonzero() == 1 + 4


def test_stream_seeds_differ_and_repeat():
    a = weights.stream_seed(2 ** 31 + 5, weights.WEIGHTS)
    assert a == weights.stream_seed(2 ** 31 + 5, weights.WEIGHTS)
    assert a != weights.stream_seed(2 ** 31 + 5, weights.POOL)
    assert 0 <= a < 2 ** 63
