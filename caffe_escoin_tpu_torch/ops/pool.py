"""Pooling, max / average / global, with Caffe's semantics (port of
``caffe_escoin_tpu/ops/pool.py:20-110``; stochastic and packed pooling
wait).

* ceil-mode output sizing, with the last window required to start inside
  the padded input (``_pooled_size``);
* average pooling divides each window by its size clipped at the input
  plus padding (``pooling_layer.cpp``: ``hend = min(hstart + k, H + pad)``):
  the padding counts, the ceil-extended edge beyond it does not. The JAX
  package divides every window by kh*kw (its ``ops/pool.py:79-83``), which
  differs from Caffe on a window that runs past the padded input.
"""

from __future__ import annotations

import math

import torch.nn.functional as F


def _pooled_size(size, k, s, p, ceil_mode):
    if ceil_mode:
        out = int(math.ceil((size + 2 * p - k) / s)) + 1
    else:
        out = int(math.floor((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1  # last window must start strictly inside
    return out


def pool2d(x, kernel, *, stride=None, padding=(0, 0), mode="max",
           ceil_mode=True, global_pool=False):
    """x: [N, H, W, C] -> [N, Ho, Wo, C]."""
    n, h, w, c = x.shape
    if global_pool:
        if mode == "max":
            return x.amax(dim=(1, 2), keepdim=True)
        if mode == "avg":
            return x.mean(dim=(1, 2), keepdim=True)
        raise ValueError(f"unknown pool mode {mode!r}")
    kh, kw = kernel
    sh, sw = stride or kernel
    ph, pw = padding
    ho = _pooled_size(h, kh, sh, ph, ceil_mode)
    wo = _pooled_size(w, kw, sw, pw, ceil_mode)
    if mode == "avg":
        # torch's count_include_pad divisor is Caffe's clipped one, and its
        # ceil sizing (the last window starts inside the input or the left
        # padding) is _pooled_size's
        out = F.avg_pool2d(x.permute(0, 3, 1, 2), (kh, kw), (sh, sw),
                           padding=(ph, pw), ceil_mode=ceil_mode,
                           count_include_pad=True).permute(0, 2, 3, 1)
        if out.shape[1:3] != (ho, wo):
            raise ValueError(f"avg pool sized {tuple(out.shape[1:3])}, "
                             f"Caffe sizes {(ho, wo)}")
        return out.contiguous()
    if mode != "max":
        raise ValueError(f"unknown pool mode {mode!r}")
    # pad right/bottom enough to cover the (possibly ceil-extended) last window
    pad_h2 = max(0, (ho - 1) * sh + kh - h - ph)
    pad_w2 = max(0, (wo - 1) * sw + kw - w - pw)
    xp = F.pad(x, (0, 0, pw, pad_w2, ph, pad_h2), value=float("-inf"))
    out = F.max_pool2d(xp.permute(0, 3, 1, 2), (kh, kw), (sh, sw))
    return out.permute(0, 2, 3, 1)[:, :ho, :wo, :].contiguous()
