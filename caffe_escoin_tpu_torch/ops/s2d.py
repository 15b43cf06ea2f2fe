"""Space-to-depth reformulation of small-cin strided stem convs (port of
``caffe_escoin_tpu/ops/s2d.py``; the weight transform in numpy, the input
transform in torch).

When a conv's stride is r in both dimensions, an [N, H, W, C] image can be
laid out as [N, H/r, W/r, r*r*C] (the r x r phases move into the channels)
and the stride-r conv becomes a stride-1 conv over that grid with a
remapped kernel:

    out(i) reads input rows  r*i + di - p,          di in [0, k)
    s2d row (ps, phase a) holds input row  r*ps + a
    =>  ps = i + floor((di - p) / r),   a = (di - p) mod r

so tap (dp, a) of the remapped kernel carries the original tap
di = r*(dp - pl) + a + p (zero where di falls outside [0, k)), with
kp = floor((k-1-p)/r) - floor(-p/r) + 1 taps and pl = -floor(-p/r) rows of
padding in front. Zero structure is kept tap by tap.

The grid is then padded, or cropped, at its far end so that the stride-1
conv gives exactly the strided conv's ``out`` positions. The JAX package
clamps that amount at 0 (its ``ops/s2d.py:53``), which leaves one grid row
too many where the strided conv drops input rows at the far edge (k=2, r=2,
p=0 on 21x21: 11x11 where the conv gives 10x10); here a negative amount
crops.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch.nn.functional as F


def s2d_axis_geometry(k: int, r: int, p: int, size: int
                      ) -> Tuple[int, int, int, int, int]:
    """One axis: (kp, pad_lo, pad_hi, out, grid) of a kernel-k stride-r
    pad-p conv over ``size`` input positions seen on the s2d grid.
    ``pad_hi < 0`` crops that many grid positions at the far end."""
    lo = math.floor(-p / r)
    hi = math.floor((k - 1 - p) / r)
    kp = hi - lo + 1
    pad_lo = -lo
    out = (size + 2 * p - k) // r + 1
    grid = -(-size // r)  # ceil: the input zero-padded up to a multiple of r
    # the stride-1 conv over pad_lo + grid + pad_hi positions gives out
    pad_hi = (out - 1) - pad_lo + kp - 1 - (grid - 1)
    return kp, pad_lo, pad_hi, out, grid


def s2d_weight(w: np.ndarray, r: int, pad: Tuple[int, int]) -> np.ndarray:
    """[kh, kw, cin, cout] stride-(r, r) kernel -> [kph, kpw, r*r*cin, cout]
    stride-1 kernel over the s2d layout (channel = (a*r + b)*cin + c)."""
    w = np.asarray(w)
    kh, kw, cin, cout = w.shape
    ph, pw = pad
    kph = s2d_axis_geometry(kh, r, ph, r)[0]
    kpw = s2d_axis_geometry(kw, r, pw, r)[0]
    wp = np.zeros((kph, kpw, r * r * cin, cout), w.dtype)
    plh = -math.floor(-ph / r)
    plw = -math.floor(-pw / r)
    for dp in range(kph):
        for a in range(r):
            di = r * (dp - plh) + a + ph
            if not 0 <= di < kh:
                continue
            for dq in range(kpw):
                for b in range(r):
                    dj = r * (dq - plw) + b + pw
                    if not 0 <= dj < kw:
                        continue
                    base = (a * r + b) * cin
                    wp[dp, dq, base:base + cin, :] = w[di, dj, :, :]
    return wp


def space_to_depth(x, r: int):
    """[N, H, W, C] -> [N, ceil(H/r), ceil(W/r), r*r*C], the bottom and right
    remainder zero-padded; channel order (phase_h, phase_w, c)."""
    n, h, w, c = x.shape
    hs, ws = -(-h // r), -(-w // r)
    if hs * r != h or ws * r != w:
        x = F.pad(x, (0, 0, 0, ws * r - w, 0, hs * r - h))
    x = x.reshape(n, hs, r, ws, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, hs, ws, r * r * c)


def s2d_input(x, r: int, kernel: Tuple[int, int], pad: Tuple[int, int]):
    """``space_to_depth`` and the grid's edge padding (or far-end crop), so
    that the remapped kernel runs at stride 1, pad 0, to exactly the
    strided conv's output size."""
    kh, kw = kernel
    ph, pw = pad
    _, h, w, _ = x.shape
    _, plh, phh, _, _ = s2d_axis_geometry(kh, r, ph, h)
    _, plw, phw, _, _ = s2d_axis_geometry(kw, r, pw, w)
    xs = space_to_depth(x, r)
    if plh or phh or plw or phw:
        # F.pad crops where an amount is negative
        xs = F.pad(xs, (0, 0, plw, phw, plh, phh))
    return xs
