"""Structural ops (port of ``caffe_escoin_tpu/ops/structural.py``): the
reference's plumbing layers (concat, slice, split, flatten, reshape,
eltwise, crop, tile, reduction, argmax) as thin torch wrappers."""

from __future__ import annotations

from typing import Sequence

import torch


def concat(xs: Sequence, axis: int = -1):
    """Caffe Concat: the blobs joined along ``axis`` (the channels of NHWC
    by default). XLA fuses it into its producers on the TPU; on the card
    it is one copy of every input."""
    return torch.cat(list(xs), dim=axis)


def slice_points(x, points: Sequence[int], axis: int = -1):
    """Split x at the given indices along axis (slice_layer.cpp)."""
    return torch.tensor_split(x, list(points), dim=axis)


def split(x, n: int = 2):
    """Caffe Split = fan-out the same blob (identity copies)."""
    return tuple(x for _ in range(n))


def flatten(x, start_axis: int = 1):
    return x.reshape(*x.shape[:start_axis], -1)


def reshape(x, shape):
    return x.reshape(tuple(shape))


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


def crop(x, ref_shape, offsets=(0, 0), axes=(1, 2)):
    """Crop x to ref_shape along axes with offsets (crop_layer.cpp)."""
    idx = [slice(None)] * x.dim()
    for ax, off in zip(axes, offsets):
        idx[ax] = slice(off, off + ref_shape[ax])
    return x[tuple(idx)]


def tile(x, reps: int, axis: int = -1):
    r = [1] * x.dim()
    r[axis] = reps
    return x.repeat(*r)


def reduction(x, op: str = "sum", axis=None, coeff: float = 1.0):
    """``op`` over ``axis`` (None: every axis)."""
    pre = {"sum": lambda a: a, "mean": lambda a: a, "asum": torch.abs,
           "sumsq": lambda a: a * a}[op](x)
    reduce = torch.mean if op == "mean" else torch.sum
    return coeff * (reduce(pre) if axis is None else reduce(pre, dim=axis))


def argmax(x, axis: int = -1):
    return torch.argmax(x, dim=axis)
