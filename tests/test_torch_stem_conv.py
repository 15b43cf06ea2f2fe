"""The stem conv (``kernels/stem_conv.py``) on the CPU.

``ops/conv.conv2d_dense`` hands a bf16 conv over an image of at most 4
channels to ``stem_conv``, which on a CPU tensor runs its plain version:
``F.conv2d`` with the bias in bf16, then ``conv_epilogue.epilogue_plain``'s
ReLU, the path every other dense conv takes, bit for bit. It is held here to
an f32 reference at the zoo's four stems (AlexNet's 11x11/s4, ResNet-50's
and GoogLeNet's 7x7/s2/p3, VGG-16's 3x3/s1/p1) at batch 2, and at odd
output sizes whose windows reach into the padding on every border. The
gate refuses what the kernel does not take (Cin 5, two groups, dilation 2,
f32, a residual, a tensor that needs grad, Cout off its widths, a
rectangular stride, a plan past a block's shared memory). The launch plan
is csrc/stem_conv.cu's layout: each kernel row's K padded to an even count
and the whole to 16 (AlexNet's 11 x 34 -> 384, the 7x7 stems' 7 x 22 ->
160, VGG's 3 x 10 -> 32), window rows at a pitch congruent to W*Cin modulo
8, within a block's shared memory; and the kernel's index arithmetic,
written out in numpy over that plan (the 16-byte copies of whole image rows
into the window, the zeroed padding, the shifted copy, the pair offsets and
masks), is the convolution. ``Net.launches`` declares one ``stem_conv`` launch for a
bf16 stem and the epilogue kernel's for an f32 one, as a forward calls
them.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.kernels import conv_epilogue, stem_conv
from caffe_escoin_tpu_torch.nn import LayerSpec, Net
from caffe_escoin_tpu_torch.ops import conv as conv_ops
from caffe_escoin_tpu_torch.utils import trace

# (image H, W, kernel, stride, pad, Cout): the zoo's stems
STEMS = {
    "alexnet_conv1": (227, 227, 11, 4, 0, 96),
    "resnet50_conv1": (224, 224, 7, 2, 3, 64),
    "googlenet_conv1": (224, 224, 7, 2, 3, 64),
    "vgg16_conv1_1": (224, 224, 3, 1, 1, 64),
}
# odd output sizes, windows over every padded border, Cin 1-4, Cout widths
ODD = {
    "7x7_s2_p3_odd": (2, 31, 29, 3, 7, 2, 3, 64),
    "3x3_s1_p1_odd": (3, 13, 17, 3, 3, 1, 1, 40),
    "5x3_s2_p2_c1": (2, 17, 23, 1, 5, 2, 2, 8),
    "11x11_s4_c4": (1, 45, 39, 4, 11, 4, 0, 64),
    "2x2_s1_c2": (2, 9, 40, 2, 2, 1, 0, 96),
}


def _inputs(n, h, w, c, k, cout, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(
        np.float32)).bfloat16()
    wt = torch.from_numpy((rng.standard_normal((k, k, c, cout))
                           * (2.0 / (k * k * c)) ** 0.5).astype(
        np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1)
    return x, wt, b


def _reference(x, w, b, stride, pad, relu=True):
    """The conv in f32 of the same bf16 values, + bias, ReLU."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2),
                   w.float().permute(3, 2, 0, 1), b.float(), stride=stride,
                   padding=pad).permute(0, 2, 3, 1)
    return torch.relu(out) if relu else out


def _former(x, w, b, stride, pad, relu=True):
    """``conv2d_dense`` as it ran before on the CPU: ``F.conv2d`` with the
    bias in x's dtype, then the epilogue entry's plain ReLU."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                   b.to(x.dtype), stride=stride, padding=pad)
    return conv_epilogue.epilogue_plain(out.permute(0, 2, 3, 1), relu=relu)


def _close_bf16(out, ref):
    """bf16 rounding of the output, the bias and the conv's sum: within
    1e-2 of the reference's largest value (the card tests' rule)."""
    err = (out.float() - ref).abs().max().item()
    assert err <= 1e-2 * ref.abs().max().item() + 1e-2, err


@pytest.mark.parametrize("name", list(STEMS))
def test_plain_at_the_zoo_stems_is_the_former_path(name):
    h, w, k, s, p, cout = STEMS[name]
    x, wt, b = _inputs(2, h, w, 3, k, cout, seed=len(name))
    geo = dict(stride=(s, s), padding=(p, p))
    assert conv_ops.runs_stem(x, wt, b, **geo)
    calls, epi = stem_conv.calls, conv_epilogue.calls
    with torch.inference_mode():
        out = conv_ops.conv2d_dense(x, wt, b, relu=True, **geo)
    assert (stem_conv.calls, conv_epilogue.calls) == (calls + 1, epi)
    assert stem_conv.launches == 0
    assert out.is_contiguous() and out.dtype == torch.bfloat16
    assert torch.equal(out, _former(x, wt, b, (s, s), (p, p)))
    _close_bf16(out, _reference(x, wt, b, s, p))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("name", list(ODD))
def test_plain_at_odd_sizes_and_padded_borders(name, relu):
    n, h, w, c, k, s, p, cout = ODD[name]
    x, wt, b = _inputs(n, h, w, c, k, cout, seed=len(name))
    out = stem_conv.stem_conv(x, wt, b, stride=(s, s), padding=(p, p),
                              relu=relu)
    ref = _reference(x, wt, b, s, p, relu)
    assert out.shape == ref.shape
    assert tuple(out.shape[1:3]) == stem_conv.plan(
        (n, h, w, c), (k, k), s, p, cout).out_shape[1:3]
    _close_bf16(out, ref)
    # no bias
    _close_bf16(stem_conv.stem_plain(x, wt, None, stride=(s, s),
                                     padding=(p, p), relu=relu),
                _reference(x, wt, torch.zeros(cout), s, p, relu))


def test_gate_refuses_what_the_kernel_does_not_take():
    x, wt, b = _inputs(1, 16, 16, 3, 3, 64, seed=3)
    geo = dict(stride=(1, 1), padding=(1, 1))
    assert stem_conv.takes(x, wt, b, **geo)
    x5, w5, _ = _inputs(1, 16, 16, 5, 3, 64, seed=3)
    assert not stem_conv.takes(x5, w5, b, **geo)                 # Cin 5
    assert not stem_conv.takes(x, wt[:, :, :3], b, groups=2, **geo)
    assert not stem_conv.takes(x, wt, b, dilation=(2, 2), **geo)
    assert not stem_conv.takes(x.float(), wt, b, **geo)          # f32
    assert not stem_conv.takes(x, wt, b, residual=True, **geo)
    wg = wt.float().requires_grad_()
    assert not stem_conv.takes(x, wg, b, **geo)                  # autograd
    with torch.no_grad():
        assert stem_conv.takes(x, wg, b, **geo)
    assert not stem_conv.takes(x, wt[..., :60], b[:60], **geo)   # Cout % 8
    wide = torch.zeros((3, 3, 3, 136), dtype=torch.bfloat16)
    assert not stem_conv.takes(x, wide, None, **geo)             # Cout 136
    assert not stem_conv.takes(x, wt, b, stride=(1, 2), padding=(1, 1))
    big = torch.empty((1, 64, 4096, 3), dtype=torch.bfloat16, device="meta")
    assert not stem_conv.takes(big, wt, b, **geo)                # smem
    assert not stem_conv.fits((1, 64, 4096, 3), (3, 3), 1, 1, 64)
    meta = torch.empty((32, 224, 224, 3), dtype=torch.bfloat16,
                       device="meta")
    assert stem_conv.takes(meta, torch.zeros((7, 7, 3, 64)), None,
                           stride=(2, 2), padding=(3, 3))


def test_conv2d_dense_keeps_the_former_path_outside_the_gate():
    """f32, a residual, and Cin 16 run ``F.conv2d`` and the epilogue entry
    as before, and call no stem entry."""
    x, wt, b = _inputs(2, 12, 12, 3, 3, 16, seed=5)
    r = torch.randn(2, 12, 12, 16).bfloat16()
    x16, w16, _ = _inputs(2, 12, 12, 16, 3, 16, seed=6)
    geo = dict(stride=(1, 1), padding=(1, 1))
    for args, res in (((x.float(), wt.float(), b), None), ((x, wt, b), r),
                      ((x16, w16, b), None)):
        calls, epi = stem_conv.calls, conv_epilogue.calls
        out = conv_ops.conv2d_dense(*args, relu=True, residual=res, **geo)
        assert (stem_conv.calls, conv_epilogue.calls) == (calls, epi + 1)
        want = F.conv2d(args[0].permute(0, 3, 1, 2), args[1].to(
            args[0].dtype).permute(3, 2, 0, 1), b.to(args[0].dtype),
            **geo).permute(0, 2, 3, 1)
        if res is not None:
            want = want + res
        assert torch.equal(out, torch.relu(want).contiguous())


@pytest.mark.parametrize("name", list(STEMS))
def test_plan_pads_k_and_fits_a_block(name):
    h, w, k, s, p, cout = STEMS[name]
    pl = stem_conv.plan((32, h, w, 3), (k, k), s, p, cout)
    assert pl.k_pad == {11: 384, 7: 160, 3: 32}[k]
    assert pl.cout_pad == cout
    assert (pl.rs - w * 3) % 8 == 0 and pl.win % 8 == 0
    assert pl.rs >= ((pl.out_shape[2] - 1) * s + k) * 3 + 8
    assert pl.smem <= stem_conv.SMEM_PER_BLOCK
    assert pl.tiles == 32 * -(-pl.out_shape[1] * pl.out_shape[2] // 256)
    dims = list(stem_conv.launch_dims(pl, (32, h, w, 3), (k, k), s, p, 132,
                                      True))
    assert dims == [32, h, w, 3, *pl.out_shape[1:], k, k, s, p, pl.cout_pad,
                    pl.k_pad, pl.rows, pl.rs, pl.win, pl.tiles_per_img,
                    pl.tiles, min(pl.tiles, 132 * pl.per_sm), pl.smem, 1]
    assert pl.per_sm == (1 if cout > 64 else 2)


def test_gemm_weight_is_hwio_by_kernel_row_and_zero_padded():
    """Each kernel row's 21 (i, j, c) rows, then one zero row (22 = even);
    7 x 22 = 154 rows up to 160; Cout 40 up to 64."""
    wt = torch.randn(7, 7, 3, 40)
    wg = stem_conv.gemm_weight(wt)
    assert wg.shape == (160, 64) and wg.dtype == torch.bfloat16
    assert wg.is_contiguous()
    by_row = wg[:154].reshape(7, 22, 64)
    assert torch.equal(by_row[:, :21, :40], wt.reshape(7, 21, 40).bfloat16())
    assert not by_row[:, 21:].any() and not wg[154:].any()
    assert not wg[:, 40:].any()
    assert stem_conv.row_k(11, 3) == 34 and stem_conv.row_k(2, 2) == 4


def _emulate(x, wt, s, p):
    """csrc/stem_conv.cu's reads, tile by tile over its plan: each window
    filled by 16-byte copies of whole image rows (zeros past the tensor's
    end), then its padding zeroed, and its copy shifted by one element; A
    read as pairs of K values, each pair at base(m) + koff from the window
    or from the shifted copy, whichever starts it at an even element, its
    padded K masked; the product with ``gemm_weight``. A window element no
    copy or zeroing wrote stays NaN and fails the test."""
    n, h, w, c = x.shape
    kh, kw, _, cout = wt.shape
    pl = stem_conv.plan(tuple(x.shape), (kh, kw), s, p, cout)
    _, ho, wo, _ = pl.out_shape
    flat = x.reshape(-1).float().numpy()
    rk, row_real = stem_conv.row_k(kw, c), kw * c
    pairs = np.arange(0, pl.k_pad, 2)
    ki, r = pairs // rk, pairs % rk
    live0, live1 = (ki < kh) & (r < row_real), (ki < kh) & (r + 1 < row_real)
    koff = np.where(live0, ki * pl.rs + r, 0)
    wg = stem_conv.gemm_weight(wt).float().numpy()
    assert not wg[pl.k_pad - (pl.k_pad - kh * rk):].any()
    out = np.zeros((n, ho * wo, cout), np.float32)
    tm, wc = stem_conv.TILE_M, w * c
    for t in range(pl.tiles):
        img, m0 = t // pl.tiles_per_img, t % pl.tiles_per_img * tm
        valid = min(tm, ho * wo - m0)
        oy0, oy1 = m0 // wo, (m0 + valid - 1) // wo
        y0, rows = oy0 * s - p, (oy1 - oy0) * s + kh
        assert rows <= pl.rows
        skew = 8 + ((img * h + y0) * w - p) * c % 8
        buf = np.full(pl.win, np.nan, np.float32)
        for row in range(rows):
            y = y0 + row
            if not 0 <= y < h:
                continue
            g0 = (img * h + y) * wc
            for src in range(g0 // 8 * 8, g0 + wc, 8):
                dst = skew + row * pl.rs + p * c + src - g0
                assert dst % 8 == 0 and 0 <= dst <= pl.win - 8
                chunk = np.zeros(8, np.float32)
                got = flat[src:src + 8]
                chunk[:got.size] = got
                buf[dst:dst + 8] = chunk
        width = ((wo - 1) * s + kw) * c
        for row in range(rows):
            start = skew + row * pl.rs
            if not 0 <= y0 + row < h:
                buf[start:start + width] = 0
            else:
                buf[start:start + p * c] = 0
                buf[start + (p + w) * c:start + max(width, (p + w) * c)] = 0
        shifted = np.full(pl.win, np.nan, np.float32)
        shifted[1:] = buf[:-1]
        m = m0 + np.minimum(np.arange(tm), valid - 1)
        base = skew + (m // wo - oy0) * s * pl.rs + m % wo * s * c
        at = base[:, None] + koff[None, :]
        odd = at % 2 == 1
        lo = np.where(odd, shifted[np.minimum(at + 1, pl.win - 1)], buf[at])
        hi = np.where(odd, shifted[np.minimum(at + 2, pl.win - 1)],
                      buf[np.minimum(at + 1, pl.win - 1)])
        a = np.zeros((tm, pl.k_pad), np.float32)
        a[:, 0::2] = np.where(live0[None, :], lo, 0)
        a[:, 1::2] = np.where(live1[None, :], hi, 0)
        assert not np.isnan(a).any()
        out[img, m0:m0 + valid] = (a @ wg)[:valid, :cout]
    return out.reshape(n, ho, wo, cout)


@pytest.mark.parametrize("shape, k, s, p, cout", [
    ((2, 227, 227, 3), 11, 4, 0, 96), ((1, 224, 224, 3), 7, 2, 3, 64),
    ((1, 30, 29, 3), 3, 1, 1, 64), ((2, 17, 23, 1), 5, 2, 2, 40),
    ((3, 13, 11, 4), 7, 3, 3, 128)],
    ids=["alexnet_b2", "resnet50_b1", "3x3_odd", "c1_cout40", "c4_cout128"])
def test_kernel_index_arithmetic_is_the_conv(shape, k, s, p, cout):
    x, wt, _ = _inputs(*shape, k, cout, seed=sum(shape))
    got = _emulate(x, wt, s, p)
    ref = _reference(x, wt, torch.zeros(cout), s, p, relu=False)
    assert got.shape == tuple(ref.shape)
    err = np.abs(got - ref.numpy()).max()
    assert err <= 1e-4 * np.abs(ref.numpy()).max(), err


@pytest.mark.parametrize("dtype, stem, epilogue", [
    (torch.bfloat16, 1, 0), (torch.float32, 0, 1)])
def test_net_declares_the_stem_as_a_forward_calls_it(dtype, stem, epilogue):
    net = Net([LayerSpec("conv1", "ConvolutionReLU", ("data",), ("c",),
                         params=dict(num_output=32, kernel=7, stride=2,
                                     pad=3))])
    shapes = {"data": (2, 20, 20, 3)}
    params = net.init(torch.Generator().manual_seed(0), shapes)
    params = {k: {n: v.to(dtype) for n, v in p.items()}
              for k, p in params.items()}
    declared = net.launches(params, shapes, dtype)
    assert (declared["stem_conv"], declared["conv_epilogue"]) == (stem,
                                                                 epilogue)
    calls, epi = stem_conv.calls, conv_epilogue.calls
    with torch.inference_mode():
        net.apply(params, {"data": torch.randn(shapes["data"]).to(dtype)})
    assert (stem_conv.calls - calls, conv_epilogue.calls - epi) == (
        stem, epilogue)


def test_kernel_counts_and_snapshot_list_stem_conv():
    assert "stem_conv" in trace.OP_KERNELS and "stem_conv" not in trace.KERNELS
    counts = trace.kernel_counts()
    assert set(counts) == set(trace.KERNELS + trace.OP_KERNELS)
    assert counts["stem_conv"] == {"calls": stem_conv.calls,
                                   "launches": stem_conv.launches,
                                   "launches_f32": 0}
