"""W-pair packed layout (port of ``caffe_escoin_tpu/ops/wpack.py``, a copy:
the JAX package cannot be imported here).

The layout packs r adjacent W-pixels into the channel dimension,
(N, H, W, C) -> (N, H, W/r, r*C), and reparametrizes every conv on it so
that the packed net computes exactly what the unpacked one does:

* interior (packed in -> packed out): kernel (kh, kw) becomes (kh, kw_p)
  over packed pixels, the lanes carrying the (phase, channel) product
  (``packed_weight``);
* entry (unpacked in -> packed out): a stride-(sw*r) conv whose kernel
  width covers the r output phases (``entry_weight``);
* exit (packed in -> unpacked out): an lhs-dilated conv (``exit_weight``);
* ``repack_weight`` covers the first two and the strided boundary
  consumers in one formula, the form the layers use.

The JAX package packs because a TPU pads a channel dimension below 128 to
128 lanes, so packing halves a narrow tensor's physical bytes. A GPU pads
nothing: on the card the layout changes the shapes the kernels see, not the
bytes. Block sparsity survives as the packed weight's own zero structure.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def pack_factor(c: int, w: int, *, lanes: int = 128) -> int:
    """Largest power of two r with c*r <= lanes and r | w; 1 means "don't
    pack"."""
    r = 1
    while (r * 2 * c <= lanes) and (w % (r * 2) == 0):
        r *= 2
    return r


def pack_nhwc(x, r: int):
    """(N, H, W, C) -> (N, H, W//r, r*C): a row-major reshape (a view of a
    contiguous tensor)."""
    n, h, w, c = x.shape
    return x.reshape(n, h, w // r, r * c)


def unpack_nhwc(xp, r: int):
    n, h, wp, rc = xp.shape
    return xp.reshape(n, h, wp * r, rc // r)


def packed_weight(w_hwio: np.ndarray, r: int, pad_w: int
                  ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Packed-in -> packed-out reparametrization of a stride-1 conv.

    out[n,h,r*v+j,co] = sum_{dy,dx,ci} xpad[n,h+dy,(r*v+j)+dx-pad_w,ci]
                        * w[dy,dx,ci,co]
    with the W tap rewritten as r*(v+du)+i:
        du = floor((j+dx-pad_w)/r),  i = (j+dx-pad_w) mod r.

    Returns (wp [kh, kw_p, r*ci, r*co], (pw_left, pw_right)) for a conv on
    the packed tensors with the same H padding and stride and the returned
    W padding in packed pixels (the right one is ``packed_pad_right``'s for
    a conv that keeps its width)."""
    kh, kw, ci, co = w_hwio.shape
    du_min = (0 - pad_w) // r  # floor division: exact for negatives
    du_max = (r - 1 + kw - 1 - pad_w) // r
    kw_p = du_max - du_min + 1
    wp = np.zeros((kh, kw_p, r * ci, r * co), w_hwio.dtype)
    for j in range(r):
        for dx in range(kw):
            t = j + dx - pad_w
            du, i = t // r, t % r
            wp[:, du - du_min, i * ci:(i + 1) * ci, j * co:(j + 1) * co] \
                += w_hwio[:, dx]
    return wp, (-du_min, du_max)


def repack_weight(w_hwio, r_in: int, r_out: int, stride_w: int, pad_w: int,
                  w_in: int):
    """General W-packed reparametrization: input packed ``r_in``, output
    packed ``r_out`` (either may be 1 = unpacked):

        out[w = r_out*v + j] = sum_dx x[w_in = sw*(r_out*v + j) + dx - pw]
        w_in = r_in*u + i  =>  t = sw*j + dx - pw ;  i = t mod r_in ;
                               du = t // r_in  (floor)

    valid iff the packed stride s' = sw*r_out / r_in is an integer (the
    stride-1 unpack needs ``exit_weight``). Returns (wp [kh, kw_p,
    r_in*ci, r_out*co], (pad_left, pad_right), stride_packed); the padding
    is made symmetric by growing the kernel with zero taps on the short
    side.

    ``w_hwio`` is a numpy array or a ``torch.Tensor``; a tensor's packed
    weight is built on its device in its dtype."""
    kh, kw, ci, co = w_hwio.shape
    kw_p, (pl, pr), s_p, du_min, front = repack_geometry(
        kw, r_in, r_out, stride_w, pad_w, w_in)
    shape = (kh, kw_p, r_in * ci, r_out * co)
    if isinstance(w_hwio, torch.Tensor):
        wp = torch.zeros(shape, dtype=w_hwio.dtype, device=w_hwio.device)
    else:
        wp = np.zeros(shape, w_hwio.dtype)
    for j in range(r_out):
        for dx in range(kw):
            t = stride_w * j + dx - pad_w
            i, du = t % r_in, t // r_in
            wp[:, du - du_min + front, i * ci:(i + 1) * ci,
               j * co:(j + 1) * co] += w_hwio[:, dx]
    return wp, (pl, pr), s_p


@functools.lru_cache(maxsize=4096)
def repack_geometry(kw: int, r_in: int, r_out: int, stride_w: int,
                    pad_w: int, w_in: int):
    """Tap-grid geometry of ``repack_weight`` without building the weight:
    (kw_p, (pad_l, pad_r), stride_packed, du_min, front_zero_taps). Cached:
    a packed layer asks for it on every forward."""
    if (stride_w * r_out) % r_in != 0:
        raise ValueError(f"packed stride sw*r_out/r_in = {stride_w}*{r_out}/"
                         f"{r_in} not integral (use exit_weight)")
    s_p = stride_w * r_out // r_in
    dus = [(stride_w * j + dx - pad_w) // r_in
           for j in range(r_out) for dx in range(kw)]
    du_min, du_max = min(dus), max(dus)
    kw_p = du_max - du_min + 1
    pl = -du_min
    # right padding from the output-width equation:
    #   (Wp_in + pl + pr - kw_p) // s_p + 1 == Wo // r_out
    wo = (w_in + 2 * pad_w - kw) // stride_w + 1
    pr = (wo // r_out - 1) * s_p + kw_p - w_in // r_in - pl
    front = 0
    if pl != pr:  # symmetrize with zero taps on the short side
        d = abs(pl - pr)
        kw_p += d
        if pl < pr:
            front = d
            pl = pr
        else:
            pr = pl
    return kw_p, (pl, pr), s_p, du_min, front


def packed_pad_right(w_in: int, kw: int, pad_w: int, r: int) -> int:
    """Right W padding (in packed pixels) making the packed conv emit
    exactly Wo/r pixels."""
    wo = (w_in + 2 * pad_w - kw) + 1
    du_min = (0 - pad_w) // r
    du_max = (r - 1 + kw - 1 - pad_w) // r
    kw_p = du_max - du_min + 1
    return wo // r - 1 + kw_p - (-du_min) - w_in // r


def entry_weight(w_hwio: np.ndarray, r: int, stride_w: int, pad_w: int
                 ) -> Tuple[np.ndarray, Tuple[int, None], int]:
    """Unpacked-in -> packed-out: one conv whose W stride is r*stride_w and
    whose kernel width covers all r output phases,

        out_p[n,h,v,j*co+c] = sum_dx x[n,h, sw*(r*v+j)+dx-pad_w, ci] w[.,dx,.]

    Returns (wp [kh, kw_e, ci, r*co], (pw_left, None), stride_w_packed);
    the right padding is ``entry_pad_right``'s."""
    kh, kw, ci, co = w_hwio.shape
    kw_e = stride_w * (r - 1) + kw
    wp = np.zeros((kh, kw_e, ci, r * co), w_hwio.dtype)
    for j in range(r):
        for dx in range(kw):
            wp[:, stride_w * j + dx, :, j * co:(j + 1) * co] += w_hwio[:, dx]
    return wp, (pad_w, None), stride_w * r


def entry_pad_right(w_in: int, kw: int, stride_w: int, pad_w: int, r: int
                    ) -> int:
    """Right W padding making the entry conv emit exactly Wo/r packed
    pixels: solve (W + pl + pr - kw_e) // (sw*r) + 1 == Wo // r."""
    wo = (w_in + 2 * pad_w - kw) // stride_w + 1
    kw_e = stride_w * (r - 1) + kw
    return (wo // r - 1) * stride_w * r + kw_e - w_in - pad_w


def exit_weight(w_hwio: np.ndarray, r: int, pad_w: int
                ) -> Tuple[np.ndarray, Tuple[int, None], int]:
    """Packed-in -> unpacked-out (stride 1): an lhs-dilated conv. Dilate the
    packed input by r along W (xd[r*u] = xp[u]); then
        out[n,h,w,co] = sum_t xd[w + t - pq] K[t],
        K[dy, t, i*ci+c, co] = w[dy, t+i-(r-1), c, co]   (zero outside),
        pq = pad_w + r - 1.
    Returns (K [kh, kw+r-1, r*ci, co], (pq_l, None), lhs_dilation_w); the
    right padding is ``exit_pad_right``'s."""
    kh, kw, ci, co = w_hwio.shape
    kw_d = kw + r - 1
    k = np.zeros((kh, kw_d, r * ci, co), w_hwio.dtype)
    for t in range(kw_d):
        for i in range(r):
            dx = t + i - (r - 1)
            if 0 <= dx < kw:
                k[:, t, i * ci:(i + 1) * ci, :] += w_hwio[:, dx]
    return k, (pad_w + r - 1, None), r


def exit_pad_right(w_packed: int, kw: int, pad_w: int, r: int) -> int:
    """Right W padding making the exit (lhs-dilated) conv emit exactly Wo
    unpacked pixels: solve Ld + pl + pr - kw_d + 1 == Wo with
    Ld = (Wp-1)*r + 1."""
    w_in = w_packed * r
    wo = w_in + 2 * pad_w - kw + 1
    ld = (w_packed - 1) * r + 1
    kw_d = kw + r - 1
    pl = pad_w + r - 1
    return wo - 1 + kw_d - pl - ld
