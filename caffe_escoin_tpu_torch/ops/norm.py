"""Normalisation (port of ``caffe_escoin_tpu/ops/norm.py``: LRN across
channels, BatchNorm at global and at batch statistics, Scale, the fused
BatchNorm + Scale, MVN)."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def _lrn_mask(c: int, groups: int, d: int, device: torch.device
              ) -> torch.Tensor:
    """1 where lane l's window term at offset ``d`` stays inside its group
    (lane l holds group l // cg, logical channel l % cg), else 0. Built once
    per (c, groups, d, device): a tensor built inside a forward would break
    CUDA-graph capture."""
    lane_c = torch.arange(c) % (c // groups)
    return ((lane_c + d >= 0) & (lane_c + d < c // groups)).float().to(device)


def lrn_across_channels(x, *, local_size=5, alpha=1e-4, beta=0.75, k=1.0,
                        groups: int = 1):
    """Local response normalization across channels (NHWC, last axis):
    y = x / (k + alpha/n * sum over the window of x_c^2)^beta, Caffe's
    ACROSS_CHANNELS with alpha divided by the window size
    (``lrn_layer.cpp:104``).

    As the JAX function: in f32, cast back to x's dtype at the end; the
    windowed sum built from shifted channel slices, added in the same
    order; for beta = 0.75, s^-0.75 as r * sqrt(r) with r = rsqrt(s).
    ``groups=r`` normalizes r independent channel blocks that share the
    channel axis (the W-pair packed layout of ops/wpack.py), with a lane
    mask on each shifted slice so that no window crosses a block."""
    half = local_size // 2
    xf = x.float()
    sq = xf * xf
    padded = F.pad(sq, (half, local_size - 1 - half))
    c = x.shape[-1]
    window = None
    for i in range(local_size):
        term = padded[..., i:i + c]
        if groups > 1:
            term = term * _lrn_mask(c, groups, i - half, x.device)
        window = term if window is None else window + term
    s = k + (alpha / local_size) * window
    if beta == 0.75:
        r = torch.rsqrt(s)
        scale = r * torch.sqrt(r)  # s^-0.75
    else:
        scale = torch.pow(s, -beta)
    return (xf * scale).to(x.dtype)


def batch_norm_inference(x, mean, var, *, eps=1e-5):
    """Caffe BatchNorm layer at TEST: normalize by stored moving stats."""
    return (x - mean) * torch.rsqrt(var + eps)


def batch_norm_train(x, *, axis=(0, 1, 2), eps=1e-5):
    """(normalized, batch mean, batch variance) for the training forward;
    the variance is the biased one (divided by the count), as Caffe
    normalizes."""
    mean = x.mean(dim=axis)
    var = x.var(dim=axis, correction=0)
    return (x - mean) * torch.rsqrt(var + eps), mean, var


def scale_bias(x, gamma, beta=None):
    """Caffe Scale layer (per-channel gamma, optional bias)."""
    out = x * gamma
    if beta is not None:
        out = out + beta
    return out


def batch_norm(x, mean, var, gamma=None, beta=None, *, eps=1e-5):
    """Fused inference BatchNorm + Scale (the layer pair)."""
    inv = torch.rsqrt(var + eps)
    if gamma is not None:
        inv = inv * gamma
    return x * inv + ((beta if beta is not None else 0.0) - mean * inv)


def mvn(x, *, axis=(1, 2, 3), normalize_variance=True, eps=1e-9):
    """Mean-variance normalization over all non-batch axes (mvn_layer.cpp)."""
    out = x - x.mean(dim=axis, keepdim=True)
    if normalize_variance:
        std = torch.sqrt((out * out).mean(dim=axis, keepdim=True))
        out = out / (std + eps)
    return out
