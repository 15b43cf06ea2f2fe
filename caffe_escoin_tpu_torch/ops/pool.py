"""Pooling, max / average / stochastic / global, with Caffe's semantics,
pooling between W-pair packed layouts, and spatial pyramid pooling (port of
``caffe_escoin_tpu/ops/pool.py``).

* ceil-mode output sizing, with the last window required to start inside
  the padded input (``_pooled_size``);
* max pooling is ``kernels/maxpool.max_pool``: the hand kernel
  ``csrc/maxpool.cu`` on the card, the plain pad / ``F.max_pool2d`` / crop
  elsewhere;
* average pooling divides each window by its size clipped at the input
  plus padding (``pooling_layer.cpp``: ``hend = min(hstart + k, H + pad)``):
  the padding counts, the ceil-extended edge beyond it does not. The JAX
  package divides every window by kh*kw (its ``ops/pool.py:79-83, 141,
  190``), which differs from Caffe on a window that runs past the padded
  input. The packed pools divide as the unpacked one does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.kernels import maxpool
from caffe_escoin_tpu_torch.ops import wpack


def _pooled_size(size, k, s, p, ceil_mode):
    if ceil_mode:
        out = int(math.ceil((size + 2 * p - k) / s)) + 1
    else:
        out = int(math.floor((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1  # last window must start strictly inside
    return out


def _pool_patches(x, kernel, stride, padding, ho, wo):
    """[N,H,W,C] -> [N,Ho,Wo,C,kh*kw] window patches (zero-padded edges)."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    n, h, w, c = x.shape
    pad_h2 = max(0, (ho - 1) * sh + kh - h - ph)
    pad_w2 = max(0, (wo - 1) * sw + kw - w - pw)
    xp = F.pad(x, (0, 0, pw, pad_w2, ph, pad_h2))
    return torch.stack([xp[:, i:i + (ho - 1) * sh + 1:sh,
                           j:j + (wo - 1) * sw + 1:sw]
                        for i in range(kh) for j in range(kw)], dim=-1)


def _window_sum(pats):
    """The sum over each window, added left to right in window order: the
    order XLA's reduction takes, so the TEST output is the JAX package's
    bit for bit."""
    acc = pats[..., 0]
    for i in range(1, pats.shape[-1]):
        acc = acc + pats[..., i]
    return acc


def _stochastic(pats, train, generator):
    total = _window_sum(pats)
    if not train:
        safe = torch.where(total > 0, total, torch.ones_like(total))
        return torch.where(total > 0, _window_sum(pats * pats) / safe,
                           torch.zeros_like(total))
    if generator is None:
        raise ValueError("stochastic pooling in training needs a generator")
    # threshold r ~ U(0, sum); the first window element whose cumulative
    # sum crosses it is the sample (pooling_layer.cpp:119-160)
    r = torch.rand(total.shape, generator=generator, device=pats.device,
                   dtype=pats.dtype) * total
    ge = pats.cumsum(dim=-1) > r[..., None]
    first = ge & ~F.pad(ge[..., :-1], (1, 0), value=False)
    return (pats * first.to(pats.dtype)).sum(dim=-1)


def _avg_clipped(x, kernel, stride, padding, ho, wo):
    """Average pooling with Caffe's clipped divisor for any padding (torch's
    own pooling takes padding up to half the window only)."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    n, h, w, c = x.shape
    total = _pool_patches(x, kernel, stride, padding, ho, wo).sum(dim=-1)

    def extent(o, k, s, p, size):
        start = torch.arange(o) * s - p
        return (torch.clamp(start + k, max=size + p) - start).to(x.dtype)

    div = (extent(ho, kh, sh, ph, h)[:, None]
           * extent(wo, kw, sw, pw, w)[None, :]).to(x.device)
    return total / div[None, :, :, None]


def takes_maxpool_kernel(mode="max", *, global_pool=False,
                         r_in: int = 1) -> bool:
    """Whether a pooling runs on the max-pool kernel (kernels/maxpool.py,
    one launch a call on the card): a max pool that is neither global nor
    on a W-pair packed input (``pool2d_packed`` pools that one with torch
    ops)."""
    return mode == "max" and not global_pool and r_in == 1


def pool2d(x, kernel, *, stride=None, padding=(0, 0), mode="max",
           ceil_mode=True, global_pool=False, train=False, generator=None):
    """x: [N, H, W, C] -> [N, Ho, Wo, C]. ``train`` and ``generator``
    matter to stochastic pooling only."""
    n, h, w, c = x.shape
    if global_pool:
        if mode == "max":
            return x.amax(dim=(1, 2), keepdim=True)
        if mode == "avg":
            return x.mean(dim=(1, 2), keepdim=True)
        if mode != "stochastic":
            raise ValueError(f"unknown pool mode {mode!r}")
        kernel, stride, padding = (h, w), (1, 1), (0, 0)
    kh, kw = kernel
    sh, sw = stride or kernel
    ph, pw = padding
    ho = _pooled_size(h, kh, sh, ph, ceil_mode)
    wo = _pooled_size(w, kw, sw, pw, ceil_mode)
    if takes_maxpool_kernel(mode, global_pool=global_pool):
        return maxpool.max_pool(x, (kh, kw), (sh, sw), (ph, pw), (ho, wo))
    if mode == "stochastic":
        return _stochastic(_pool_patches(x, (kh, kw), (sh, sw), (ph, pw), ho,
                                         wo), train, generator)
    if mode == "avg" and (2 * ph > kh or 2 * pw > kw):
        return _avg_clipped(x, (kh, kw), (sh, sw), (ph, pw), ho, wo)
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
    raise ValueError(f"unknown pool mode {mode!r}")


def _check_mode(mode, who):
    if mode not in ("max", "avg"):
        raise ValueError(f"{who}: unsupported mode {mode!r}")


def pool2d_packed_out(x, kernel, *, stride=None, padding=(0, 0), mode="max",
                      ceil_mode=True, r: int = 2):
    """Pooling that emits the W-pair packed layout (ops/wpack.py):
    [N, H, W, C] -> [N, Ho, Wo//r, r*C] with out_p[..., v, j*C+c] =
    pool_out[..., r*v + j, c]. Max and average only.

    The JAX package pools each output phase separately and concatenates
    the phases on the lane axis, so that no TPU retile of the pooled map
    materializes. On the card the packed layout is a row-major reshape of
    the contiguous pooled map, a view, so this is ``pool2d`` then
    ``pack_nhwc``."""
    _check_mode(mode, "pool2d_packed_out")
    out = pool2d(x, kernel, stride=stride, padding=padding, mode=mode,
                 ceil_mode=ceil_mode)
    if out.shape[2] % r:
        raise ValueError(f"pooled width {out.shape[2]} not divisible by "
                         f"pack {r}")
    return wpack.pack_nhwc(out, r)


def pool2d_packed(x, kernel, *, stride=None, padding=(0, 0), mode="max",
                  ceil_mode=True, r_in: int = 1, r_out: int = 1):
    """Pooling between W-pair packed layouts (ops/wpack.py):
    [N, H, W/r_in, r_in*C] -> [N, Ho, Wo/r_out, r_out*C]. Max and average
    only.

    The tap algebra of ``repack_weight``: output phase j's tap dx reads
    packed pixel offset du = floor((sw*j + dx - pw)/r_in), lane block
    i = (sw*j + dx - pw) mod r_in; valid iff the packed W stride
    s' = sw*r_out/r_in is integral. H pools first, as one pooling with a
    (kh, 1) window on the channels_last view; then each output phase
    reduces its (W-shifted, lane-block) views. Where sw == r_in (ResNet-50's
    and VGG-16's packed pools), every phase's taps are phase 0's shifted by
    j packed pixels, so one reduction over unit-stride shifted views serves
    all phases and the packed output is its lane-merge reshape.

    Average pooling divides by Caffe's clipped window, as ``pool2d``: the H
    pass divides by the window's H extent, the W pass by its W extent."""
    if r_in == 1 and r_out > 1:
        return pool2d_packed_out(x, kernel, stride=stride, padding=padding,
                                 mode=mode, ceil_mode=ceil_mode, r=r_out)
    _check_mode(mode, "pool2d_packed")
    n, h, wp, cc = x.shape
    kh, kw = kernel
    sh, sw = stride or kernel
    ph, pw = padding
    if (sw * r_out) % r_in:
        raise ValueError(f"packed pool stride {sw}*{r_out}/{r_in} not "
                         f"integral")
    s_p = sw * r_out // r_in
    c = cc // r_in
    w_log = wp * r_in
    ho = _pooled_size(h, kh, sh, ph, ceil_mode)
    wo = _pooled_size(w_log, kw, sw, pw, ceil_mode)
    if wo % r_out:
        raise ValueError(f"pooled width {wo} not divisible by {r_out}")
    # H pass: one (kh, 1) pooling on the channels_last view of x
    xv = x.permute(0, 3, 1, 2)
    if mode == "max":
        xh = F.max_pool2d(xv, (kh, 1), (sh, 1), padding=(ph, 0),
                          ceil_mode=ceil_mode)
        init, op = float("-inf"), torch.maximum
    else:
        xh = F.avg_pool2d(xv, (kh, 1), (sh, 1), padding=(ph, 0),
                          ceil_mode=ceil_mode, count_include_pad=True)
        init, op = 0.0, torch.add
    if xh.shape[2] != ho:
        raise ValueError(f"{mode} pool sized {xh.shape[2]} rows, Caffe "
                         f"sizes {ho}")
    xh = xh.permute(0, 2, 3, 1)
    # W pass: taps (du, i) per output phase j
    taps = [[((sw * j + dx - pw) // r_in, (sw * j + dx - pw) % r_in)
             for dx in range(kw)] for j in range(r_out)]
    dus = [du for tl in taps for du, _ in tl]
    pl_p = max(0, -min(dus))
    if sw == r_in:
        # out_j[v] = U[r_out*v + j]: U reduces phase 0's taps over
        # unit-stride shifted views, one per logical output column
        pr_p = max(0, (wo - 1) + max(du for du, _ in taps[0]) - (wp - 1))
        xw = F.pad(xh, (0, 0, pl_p, pr_p), value=init)
        acc = None
        for du, i in taps[0]:
            sl = xw[:, :, pl_p + du:pl_p + du + wo, i * c:(i + 1) * c]
            acc = sl if acc is None else op(acc, sl)
        out = acc.reshape(n, ho, wo // r_out, r_out * c)
    else:
        vmax = wo // r_out - 1
        pr_p = max(0, s_p * vmax + max(dus) - (wp - 1))
        xw = F.pad(xh, (0, 0, pl_p, pr_p), value=init)
        phases = []
        for tl in taps:
            acc = None
            for du, i in tl:
                u0 = pl_p + du
                sl = xw[:, :, u0:u0 + s_p * vmax + 1:s_p, i * c:(i + 1) * c]
                acc = sl if acc is None else op(acc, sl)
            phases.append(acc)
        out = torch.cat(phases, dim=-1)
    if mode == "avg":
        out = out / kw
        # the windows at the right edge that run past the padded input:
        # Caffe divides by the part inside it
        for w in range(max(0, (w_log + 2 * pw - kw) // sw + 1), wo):
            extent = w_log + 2 * pw - w * sw
            v, j = divmod(w, r_out)
            out[:, :, v, j * c:(j + 1) * c] *= kw / extent
    return out.contiguous()


def spp(x, pyramid_height: int, *, mode="max"):
    """Spatial pyramid pooling (spp_layer.cpp): level l pools to 2^l x 2^l
    bins, each level flattened and all concatenated -> [N, C * sum 4^l]
    (each level's (bin_h, bin_w, c) order, as the JAX package's)."""
    n, h, w, c = x.shape
    outs = []
    for level in range(pyramid_height):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pooled = pool2d(x, (kh, kw), stride=(kh, kw), padding=(ph, pw),
                        mode=mode, ceil_mode=True)
        outs.append(pooled[:, :bins, :bins, :].reshape(n, -1))
    return torch.cat(outs, dim=-1)
