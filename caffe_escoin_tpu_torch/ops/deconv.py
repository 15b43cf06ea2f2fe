"""Transposed convolution, the Caffe Deconvolution layer (port of
``caffe_escoin_tpu/ops/deconv.py``).

Reference: `src/caffe/layers/deconv_layer.cpp`, conv with forward and
backward swapped: out_size = (in - 1) * stride + dilation * (kernel - 1)
+ 1 - 2 * pad. The JAX function is an XLA conv over the stride-dilated
input with the flipped kernel; here ``F.conv_transpose2d`` computes the
same function (cuDNN on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def deconv2d(x, w, bias=None, *, stride=(1, 1), padding=(0, 0),
             dilation=(1, 1), relu=False):
    """x: [N, H, W, Cin], w: [KH, KW, Cin, Cout] -> [N, Ho, Wo, Cout]."""
    out = F.conv_transpose2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype).permute(2, 3, 0, 1),
        None if bias is None else bias.to(x.dtype), stride=tuple(stride),
        padding=tuple(padding), dilation=tuple(dilation))
    out = out.permute(0, 2, 3, 1)
    if relu:
        out = torch.relu(out)
    return out.contiguous()
