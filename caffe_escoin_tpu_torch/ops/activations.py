"""Activations of the slice (port of ``caffe_escoin_tpu/ops/activations.py``
``relu``, ``dropout`` and ``softmax``)."""

from __future__ import annotations

import torch


def relu(x, negative_slope: float = 0.0):
    if negative_slope:
        return torch.where(x > 0, x, negative_slope * x)
    return torch.relu(x)


def dropout(x, rate: float, *, train: bool = False):
    """Inverted dropout: the identity at inference. The training forward
    (a random mask scaled by 1/(1-rate)) waits for the training port."""
    if not train or rate <= 0.0:
        return x
    raise NotImplementedError(
        "dropout(train=True) is not ported: it comes with the training port")


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)
