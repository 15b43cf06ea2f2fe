"""Oracles in plain torch, f32 (port of
``caffe_escoin_tpu/kernels/reference.py``).

Simple, obviously correct implementations that the executors are held
against: per-kernel-offset shift and matmul loops, no conv primitive.
Activations NHWC, conv weights HWIO, as everywhere in the package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.float32)


def _out_size(size, k, s, p, d):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _windows(xp, kernel, stride, dilation, ho, wo):
    """The strided input window of each kernel offset, in (kh, kw) order."""
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    return [xp[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
               j * dw:j * dw + (wo - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]


def conv2d_reference(x, w, b=None, *, stride=(1, 1), padding=(0, 0),
                     dilation=(1, 1), groups: int = 1, relu: bool = False):
    """Direct convolution by explicit kernel-offset accumulation.

    x: [N, H, W, Cin], w: [KH, KW, Cin//groups, Cout], b: [Cout] or None.
    Returns [N, Ho, Wo, Cout] in float32."""
    x, w = _f32(x), _f32(w)
    n, h, wd, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    if cin != cin_g * groups:
        raise ValueError(f"cin {cin} != {cin_g} x {groups} groups")
    ho = _out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = _out_size(wd, kw, stride[1], padding[1], dilation[1])
    xp = F.pad(x, (0, 0, padding[1], padding[1], padding[0], padding[0]))
    cout_g = cout // groups
    outs = []
    for g in range(groups):
        xg = xp[..., g * cin_g:(g + 1) * cin_g]
        acc = torch.zeros((n, ho, wo, cout_g), dtype=torch.float32,
                          device=x.device)
        for off, patch in enumerate(_windows(xg, (kh, kw), stride, dilation,
                                             ho, wo)):
            i, j = divmod(off, kw)
            acc = acc + patch @ w[i, j, :, g * cout_g:(g + 1) * cout_g]
        outs.append(acc)
    out = torch.cat(outs, dim=-1)
    if b is not None:
        out = out + _f32(b)
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out


def spmm_reference(w_dense, bmat):
    """C = W @ B (W is the densified sparse operand)."""
    return _f32(w_dense) @ _f32(bmat)


def im2col_reference(x, kernel, *, stride=(1, 1), padding=(0, 0),
                     dilation=(1, 1)):
    """Patch extraction: [N, H, W, C] -> [N, Ho, Wo, KH*KW*C], columns in
    (kh, kw, c) order, the lowered SpMM path's layout. Keeps x's dtype."""
    x = torch.as_tensor(x)
    n, h, wd, c = x.shape
    kh, kw = kernel
    ho = _out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = _out_size(wd, kw, stride[1], padding[1], dilation[1])
    xp = F.pad(x, (0, 0, padding[1], padding[1], padding[0], padding[0]))
    return torch.cat(_windows(xp, kernel, stride, dilation, ho, wo),
                     dim=-1).reshape(n, ho, wo, kh * kw * c)


def pool2d_reference(x, kernel, *, stride=None, padding=(0, 0), mode="max"):
    """Pooling, NHWC, mode "max" or "avg", with floor output sizing (so no
    window runs past the padded input) and the average over the full window,
    padding included."""
    x = _f32(x)
    kh, kw = kernel
    sh, sw = stride or kernel
    ph, pw = padding
    n, h, wd, c = x.shape
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (wd + 2 * pw - kw) // sw + 1
    pad_val = float("-inf") if mode == "max" else 0.0
    xp = F.pad(x, (0, 0, pw, pw, ph, ph), value=pad_val)
    stack = torch.stack(_windows(xp, kernel, (sh, sw), (1, 1), ho, wo))
    if mode == "max":
        return stack.amax(dim=0)
    return stack.sum(dim=0) / (kh * kw)
