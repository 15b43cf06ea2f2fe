"""Normalisation (port of ``caffe_escoin_tpu/ops/norm.py``: LRN across
channels, BatchNorm at global and at batch statistics, Scale, the fused
BatchNorm + Scale, MVN).

Under ``batch_stats_over(group)`` a training BatchNorm normalizes by the
statistics of the batch of every rank of ``group``, which the JAX
package's batch-sharded step computes over its global batch
(parallel/dp.py)."""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

# the process group whose ranks' batches a training BatchNorm normalizes
# over (None: this rank's batch alone)
_STATS_GROUP = contextvars.ContextVar("batch_stats_group", default=None)


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


@contextlib.contextmanager
def batch_stats_over(group):
    """Inside, a training BatchNorm takes its batch statistics over the
    batches of every rank of ``group`` (a torch.distributed process group;
    None: this rank's alone)."""
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


class _SumOverGroup(torch.autograd.Function):
    """An all-reduce sum that autograd differentiates: the gradient that
    reaches each rank's input is the sum of every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_count(x, axis) -> int:
    """The number of values per channel a training BatchNorm's statistics
    cover: this batch's, times the ranks of ``batch_stats_over``'s group."""
    group = _STATS_GROUP.get()
    n = math.prod(x.shape[i] for i in axis)
    return n if group is None else n * dist.get_world_size(group)


def batch_norm_train(x, *, axis=(0, 1, 2), eps=1e-5):
    """(normalized, batch mean, batch variance) for the training forward;
    the variance is the biased one (divided by the count), as Caffe
    normalizes. Under ``batch_stats_over`` both are sums over the group's
    ranks (two all-reduces, the variance's about the global mean)."""
    group = _STATS_GROUP.get()
    if group is None:
        mean = x.mean(dim=axis)
        var = x.var(dim=axis, correction=0)
        return (x - mean) * torch.rsqrt(var + eps), mean, var
    count = batch_count(x, axis)
    mean = _SumOverGroup.apply(x.sum(dim=axis), group) / count
    d = x - mean
    var = _SumOverGroup.apply((d * d).sum(dim=axis), group) / count
    return d * torch.rsqrt(var + eps), mean, var


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
