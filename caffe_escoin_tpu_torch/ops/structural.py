"""Structural ops of the slice (port of ``caffe_escoin_tpu/ops/structural.py``
``concat`` and ``eltwise``; the other plumbing ops wait)."""

from __future__ import annotations

from typing import Sequence

import torch


def concat(xs: Sequence, axis: int = -1):
    """Caffe Concat: the blobs joined along ``axis`` (the channels of NHWC
    by default). XLA fuses it into its producers on the TPU; on the card
    it is one copy of every input."""
    return torch.cat(list(xs), dim=axis)


def eltwise(xs: Sequence, op: str = "sum", coeffs=None):
    xs = list(xs)
    if op == "sum":
        if coeffs is None:
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        out = coeffs[0] * xs[0]
        for c, x in zip(coeffs[1:], xs[1:]):
            out = out + c * x
        return out
    if op == "prod":
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out
    if op == "max":
        out = xs[0]
        for x in xs[1:]:
            out = out.maximum(x)
        return out
    raise ValueError(f"unknown eltwise op {op!r}")
