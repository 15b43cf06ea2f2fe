"""Activations (port of ``caffe_escoin_tpu/ops/activations.py``): Caffe's
activation layers as functions, with Caffe's semantics (ReLU's
negative_slope, BNLL's overflow guard, Power's (shift + scale*x)^power,
Exp and Log in a base, base <= 0 meaning e)."""

from __future__ import annotations

import math

import torch


def relu(x, negative_slope: float = 0.0):
    if negative_slope:
        return torch.where(x > 0, x, negative_slope * x)
    return torch.relu(x)


def prelu(x, alpha):
    """alpha: per-channel [C] (broadcast over the last axis) or [1]."""
    return torch.where(x > 0, x, alpha * x)


def elu(x, alpha: float = 1.0):
    return torch.where(x > 0, x, alpha * (torch.exp(x.clamp(max=0.0)) - 1.0))


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def bnll(x):
    """log(1 + exp(x)), overflow-safe (bnll_layer.cpp's threshold trick)."""
    return torch.where(x > 0, x + torch.log1p(torch.exp(-x.abs())),
                       torch.log1p(torch.exp(x.clamp(max=0.0))))


def power(x, power: float = 1.0, scale: float = 1.0, shift: float = 0.0):
    return torch.pow(shift + scale * x, power)


def exp(x, base: float = -1.0, scale: float = 1.0, shift: float = 0.0):
    y = scale * x + shift
    if base > 0:
        return torch.pow(base, y)
    return torch.exp(y)


def log(x, base: float = -1.0, scale: float = 1.0, shift: float = 0.0):
    out = torch.log(scale * x + shift)
    if base > 0:
        out = out / math.log(base)
    return out


def absval(x):
    return x.abs()


def threshold(x, thresh: float = 0.0):
    return (x > thresh).to(x.dtype)


def dropout(x, rate: float, *, generator=None, train: bool = False):
    """Inverted dropout (dropout_layer.cpp scales by 1/(1-rate) in
    training): the identity at inference and at rate 0; in training each
    element survives with probability 1 - rate, drawn from ``generator``
    (a ``torch.Generator`` on x's device), and survivors are x / (1 -
    rate)."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout(train=True) requires a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)
