"""The port's W-pair packed layout (caffe_escoin_tpu_torch/ops/wpack.py)
against the JAX package's (caffe_escoin_tpu/ops/wpack.py), over the grids of
tests/test_wpack.py: every function gives bit-equal arrays on the same
seeded numpy inputs, the torch ``repack_weight`` equals the numpy one, and
the packed conv (``F.conv2d`` on the packed tensors) equals the unpacked
one in f32 (rtol 1e-5, atol 1e-5: sums in another order)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.ops import wpack as jwpack  # noqa: E402

from caffe_escoin_tpu_torch.ops import wpack  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _conv(x, w, stride=(1, 1), padding=(0, 0)):
    """NHWC x, HWIO w (numpy) -> NHWC numpy, through F.conv2d."""
    out = F.conv2d(torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2),
                   torch.from_numpy(np.ascontiguousarray(w)).permute(3, 2, 0, 1),
                   stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1).numpy()


def _conv_lr(x, w, stride, pad_h, pad_l, pad_r):
    """A conv with asymmetric W padding (a negative one crops, as in
    ``lax.conv_general_dilated``): pad first, then a valid conv."""
    if pad_r < 0:
        x, pad_r = x[:, :, :pad_r], 0
    xp = np.pad(x, ((0, 0), (0, 0), (pad_l, pad_r), (0, 0)))
    return _conv(xp, w, stride=stride, padding=(pad_h, 0))


@pytest.mark.parametrize("kw,pad_w,r", [
    (3, 1, 2), (3, 1, 4), (1, 0, 2), (5, 2, 2), (3, 0, 2), (2, 1, 2)])
def test_packed_weight_matches_jax(kw, pad_w, r):
    rng = np.random.default_rng(0)
    n, h, w, c = 2, 5, 8, 4
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = rng.standard_normal((3, kw, c, 3)).astype(np.float32)
    wp, pads = wpack.packed_weight(wt, r, pad_w)
    jwp, jpads = jwpack.packed_weight(wt, r, pad_w)
    assert np.array_equal(wp, jwp) and pads == jpads
    pr = wpack.packed_pad_right(w, kw, pad_w, r)
    assert pr == jwpack.packed_pad_right(w, kw, pad_w, r)
    xp = wpack.pack_nhwc(x, r)
    assert np.array_equal(xp, jwpack.pack_nhwc(x, r))
    if (w + 2 * pad_w - kw + 1) % r:
        return  # the JAX test's skip: output width not divisible by r
    got = wpack.unpack_nhwc(_conv_lr(xp, wp, (1, 1), 1, pads[0], pr), r)
    want = _conv(x, wt, padding=(1, pad_w))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw,pad_w,sw,r", [
    (1, 0, 1, 2), (1, 0, 1, 4), (3, 1, 1, 2), (1, 0, 2, 2), (3, 1, 2, 2)])
def test_entry_weight_matches_jax(kw, pad_w, sw, r):
    rng = np.random.default_rng(1)
    n, h, w, c = 2, 4, 16, 4
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = rng.standard_normal((1, kw, c, 3)).astype(np.float32)
    wp, (pl, pr_none), swp = wpack.entry_weight(wt, r, sw, pad_w)
    jwp, (jpl, _), jswp = jwpack.entry_weight(wt, r, sw, pad_w)
    assert np.array_equal(wp, jwp) and (pl, swp) == (jpl, jswp)
    assert pr_none is None
    pr = wpack.entry_pad_right(w, kw, sw, pad_w, r)
    assert pr == jwpack.entry_pad_right(w, kw, sw, pad_w, r)
    if ((w + 2 * pad_w - kw) // sw + 1) % r:
        return
    got = wpack.unpack_nhwc(_conv_lr(x, wp, (1, swp), 0, pl, pr), r)
    want = _conv(x, wt, stride=(1, sw), padding=(0, pad_w))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw,pad_w,r", [
    (1, 0, 2), (3, 1, 2), (1, 0, 4), (5, 2, 2)])
def test_exit_weight_matches_jax(kw, pad_w, r):
    rng = np.random.default_rng(2)
    n, h, w, c = 2, 4, 16, 4
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = rng.standard_normal((1, kw, c, 3)).astype(np.float32)
    k, (pl, _), dil = wpack.exit_weight(wt, r, pad_w)
    jk, (jpl, _), jdil = jwpack.exit_weight(wt, r, pad_w)
    assert np.array_equal(k, jk) and (pl, dil) == (jpl, jdil)
    pr = wpack.exit_pad_right(w // r, kw, pad_w, r)
    assert pr == jwpack.exit_pad_right(w // r, kw, pad_w, r)
    # the lhs-dilated conv: dilate the packed input by r along W, then pad
    xp = wpack.pack_nhwc(x, r)
    xd = np.zeros((n, h, (w // r - 1) * r + 1, r * c), np.float32)
    xd[:, :, ::r] = xp
    got = _conv_lr(xd, k, (1, 1), 0, pl, pr)
    want = _conv(x, wt, padding=(0, pad_w))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("r_in,r_out,sw,kw,pad_w", [
    (2, 2, 1, 3, 1), (2, 2, 1, 1, 0), (4, 4, 1, 3, 1),
    (1, 2, 1, 1, 0), (1, 2, 2, 7, 3), (1, 4, 1, 3, 1),
    (2, 1, 2, 1, 0), (2, 1, 2, 3, 1), (4, 2, 2, 1, 0),
    (2, 4, 1, 1, 0), (2, 2, 1, 5, 2),
])
def test_repack_weight_matches_jax(r_in, r_out, sw, kw, pad_w):
    rng = np.random.default_rng(7)
    n, h, w, c, co = 2, 4, 16, 4, 3
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = rng.standard_normal((1, kw, c, co)).astype(np.float32)
    wp, (pl, pr), s_p = wpack.repack_weight(wt, r_in, r_out, sw, pad_w, w)
    jwp, jpads, js_p = jwpack.repack_weight(wt, r_in, r_out, sw, pad_w, w)
    assert np.array_equal(wp, jwp) and ((pl, pr), s_p) == (jpads, js_p)
    assert wpack.repack_geometry(kw, r_in, r_out, sw, pad_w, w) == \
        jwpack.repack_geometry(kw, r_in, r_out, sw, pad_w, w)
    # the torch form, on the weight's device and in its dtype
    twp, tpads, ts_p = wpack.repack_weight(torch.from_numpy(wt), r_in, r_out,
                                           sw, pad_w, w)
    assert twp.dtype == torch.float32 and (tpads, ts_p) == ((pl, pr), s_p)
    assert np.array_equal(twp.numpy(), wp)
    assert wpack.repack_weight(torch.from_numpy(wt).bfloat16(), r_in, r_out,
                               sw, pad_w, w)[0].dtype == torch.bfloat16
    assert pl == pr  # symmetrized
    if ((w + 2 * pad_w - kw) // sw + 1) % r_out or w % r_in:
        return
    got = wpack.unpack_nhwc(
        _conv(wpack.pack_nhwc(x, r_in), wp, stride=(1, s_p),
              padding=(0, pl)), r_out)
    want = _conv(x, wt, stride=(1, sw), padding=(0, pad_w))
    np.testing.assert_allclose(got, want, **TOL)


def test_repack_rejects_fractional_stride():
    wt = np.zeros((1, 1, 4, 3), np.float32)
    with pytest.raises(AssertionError):
        jwpack.repack_weight(wt, 2, 1, 1, 0, 16)
    with pytest.raises(ValueError):
        wpack.repack_weight(wt, 2, 1, 1, 0, 16)
    with pytest.raises(ValueError):
        wpack.repack_weight(torch.from_numpy(wt), 2, 1, 1, 0, 16)


@pytest.mark.parametrize("c,w", [(64, 56), (32, 56), (32, 28), (16, 28),
                                 (128, 56), (96, 28), (64, 55), (3, 224),
                                 (8, 16)])
def test_pack_factor_matches_jax(c, w):
    assert wpack.pack_factor(c, w) == jwpack.pack_factor(c, w)
    assert wpack.pack_factor(c, w, lanes=8) == jwpack.pack_factor(c, w,
                                                                  lanes=8)


def test_pack_roundtrip():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
    assert np.array_equal(wpack.pack_nhwc(x, 2), jwpack.pack_nhwc(x, 2))
    np.testing.assert_array_equal(
        wpack.unpack_nhwc(wpack.pack_nhwc(x, 2), 2), x)
    t = torch.from_numpy(x)
    p = wpack.pack_nhwc(t, 2)
    assert p.data_ptr() == t.data_ptr()  # a view of a contiguous tensor
    assert torch.equal(wpack.unpack_nhwc(p, 2), t)
