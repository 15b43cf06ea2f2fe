"""Spatial (feature-map) partitioning with halo exchange (port of
``caffe_escoin_tpu/parallel/halo.py``).

A feature map's H dimension is split over the mesh's ``model`` axis. Each
rank holds its own rows ([N, H / shards, W, C], the JAX ``P(None,
"model")`` shard) and, before a 'same'-padded conv, takes (KH-1)/2
boundary rows from each neighbour (``halo_exchange``: a send and a receive
each way through ``dist.batch_isend_irecv`` on the axis's group). The
ranks at the global edges take zero rows, which are exactly the global
zero padding, so the convs run with no H padding of their own. Every
function takes and returns the rank's local rows; there is no global
tensor in torch.

``spatial_sconv2d(engine="pallas")`` keeps the JAX name for the Pallas
kernel's counterpart, the garbage-column kernel of kernels/sconv_gc.py; it
raises where that kernel does not take the shape, and never re-routes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import ConvMode
from caffe_escoin_tpu_torch.kernels import sconv_gc
from caffe_escoin_tpu_torch.ops import conv as conv_ops
from caffe_escoin_tpu_torch.parallel.mesh import (axis_group, axis_index,
                                                  axis_size)
from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight

ENGINES = ("auto", "pallas")


def shard_rows(x: torch.Tensor, mesh, axis_name: str = "model"
               ) -> torch.Tensor:
    """This rank's rows of a whole map [N, H, W, C] (H divisible by the
    axis size), as the JAX ``P(None, axis_name)`` shard."""
    n = axis_size(mesh, axis_name)
    if x.shape[1] % n:
        raise ValueError(f"H {x.shape[1]} is not divisible by {n} shards")
    return x.chunk(n, dim=1)[axis_index(mesh, axis_name)].contiguous()


def gather_rows(x_local: torch.Tensor, mesh,
                axis_name: str = "model") -> torch.Tensor:
    """The whole map from every rank's rows (an all-gather on the axis)."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x_local
    parts = [torch.empty_like(x_local) for _ in range(n)]
    dist.all_gather(parts, x_local.contiguous(),
                    group=axis_group(mesh, axis_name))
    return torch.cat(parts, dim=1)


def halo_exchange(x_local: torch.Tensor, halo: int, mesh,
                  axis_name: str = "model") -> torch.Tensor:
    """x_local [N, Hl, W, C] -> [N, Hl + 2*halo, W, C]: the previous rank's
    last ``halo`` rows on top, the next rank's first ``halo`` rows below,
    zeros at the global edges (and at one shard)."""
    n = axis_size(mesh, axis_name)
    if halo == 0 or n == 1:
        return F.pad(x_local, (0, 0, 0, 0, halo, halo))
    idx = axis_index(mesh, axis_name)
    group = axis_group(mesh, axis_name)
    nb, _, w, c = x_local.shape
    top = x_local.new_zeros((nb, halo, w, c))
    bottom = x_local.new_zeros((nb, halo, w, c))
    ops = []
    if idx > 0:
        prev = dist.get_global_rank(group, idx - 1)
        ops += [dist.P2POp(dist.isend, x_local[:, :halo].contiguous(), prev,
                           group),
                dist.P2POp(dist.irecv, top, prev, group)]
    if idx < n - 1:
        nxt = dist.get_global_rank(group, idx + 1)
        ops += [dist.P2POp(dist.isend, x_local[:, -halo:].contiguous(), nxt,
                           group),
                dist.P2POp(dist.irecv, bottom, nxt, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([top, x_local, bottom], dim=1)


def _same_pad_h(kernel_shape, padding) -> None:
    if padding[0] != (kernel_shape[0] - 1) // 2:
        raise ValueError("spatial partitioning needs 'same' H padding "
                         f"((kh-1)//2), got kernel {kernel_shape}, padding "
                         f"{padding}")


def spatial_conv2d(x_local, w, bias=None, *, mesh, kernel: Tuple[int, int],
                   padding: Tuple[int, int], axis_name: str = "model",
                   relu: bool = False):
    """Dense conv of a map whose H is split over ``axis_name``: stride 1,
    'same' H padding (the halo is the global padding). x_local: this rank's
    rows [N, Hl, W, C]; w: HWIO."""
    _same_pad_h(kernel, padding)
    ext = halo_exchange(x_local, padding[0], mesh, axis_name)
    return conv_ops.conv2d_dense(ext, w, bias, padding=(0, padding[1]),
                                 relu=relu)


def spatial_sconv2d(x_local, aligned: AlignedConvWeight, *, mesh, padding,
                    policy, axis_name: str = "model", relu: bool = False,
                    stride: Tuple[int, int] = (1, 1), engine: str = "auto"):
    """Direct sparse conv of a map whose H is split over ``axis_name``: the
    halo exchange, then one sparse conv per rank on the extended rows with
    no H padding.

    ``engine="auto"`` runs the dispatcher (``ops/conv.conv2d_sconv``,
    batch-parallel); ``"pallas"`` runs the garbage-column kernel
    (kernels/sconv_gc.py; stride 1 only) and raises where its
    ``supported`` or ``fits_budget`` refuses the extended rows.

    A stride s needs every rank's row count divisible by s, so that the
    output rows each rank computes start at a multiple of s whatever its
    offset (the JAX guard). The extended rows can admit one trailing
    window that the whole map has not; the output keeps exactly the
    rank's Hl / s rows."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    stride, padding = tuple(stride), tuple(padding)
    _same_pad_h(aligned.kernel_shape, padding)
    h_local = x_local.shape[1]
    if h_local % stride[0]:
        raise ValueError(f"stride {stride[0]} needs per-shard rows "
                         f"({h_local}) divisible by it")
    if engine == "pallas" and stride != (1, 1):
        raise ValueError(f"the pallas engine (sconv_gc) is stride-1, got "
                         f"stride {stride}")
    ext = halo_exchange(x_local, padding[0], mesh, axis_name)
    if engine == "pallas":
        if not (sconv_gc.supported(ext, aligned)
                and sconv_gc.fits_budget(ext, aligned)):
            raise ValueError(
                f"sconv_gc does not take input {tuple(ext.shape)} with "
                f"kernel {aligned.kernel_shape}, cin_pad {aligned.cin_pad}, "
                f"blocks {None if aligned.bsc is None else aligned.bsc.block_shape}"
                f" (sconv_gc.supported and fits_budget)")
        out = sconv_gc.sconv(ext, aligned, padding=(0, padding[1]),
                             relu=relu, mxu_dtype=policy.mxu_dtype)
    else:
        out = conv_ops.conv2d_sconv(ext, aligned, stride=stride,
                                    padding=(0, padding[1]), dilation=(1, 1),
                                    relu=relu, policy=policy,
                                    batch_parallel=True)
    return out[:, :h_local // stride[0]]


def _odd_kernel_pads(aligneds: Sequence[AlignedConvWeight]):
    pads = []
    for a in aligneds:
        kh, kw = a.kernel_shape
        if kh % 2 == 0:
            raise ValueError(f"a spatial chain needs odd kernels ('same' "
                             f"pad), got {a.kernel_shape}")
        pads.append(((kh - 1) // 2, (kw - 1) // 2))
    return pads


def spatial_sconv_tower(x_local, aligneds: Sequence[AlignedConvWeight], *,
                        mesh, policy, axis_name: str = "model",
                        relu: bool = True):
    """A chain of stride-1 'same'-padded sparse convs with ONE halo
    exchange: the sum of the chain's halos is exchanged once, and layer i
    computes on rows extended by the halos of the layers after it, so its
    margin rows hold what the whole map holds there. The price is the
    duplicated compute on the shrinking margin.

    The whole map pads every layer with zeros, so after each layer the
    remaining margin rows of a rank at a global edge are zeroed: a conv of
    real data would stand there otherwise (a 2% edge mismatch, the JAX
    docstring measured). A halo larger than a rank's rows raises."""
    pads = _odd_kernel_pads(aligneds)
    total = sum(ph for ph, _ in pads)
    if x_local.shape[1] < total:
        raise ValueError(f"deep halo {total} exceeds per-shard rows "
                         f"{x_local.shape[1]}; split the chain")
    idx, n = axis_index(mesh, axis_name), axis_size(mesh, axis_name)
    ext = halo_exchange(x_local, total, mesh, axis_name)
    m = total
    for a, (ph, pw) in zip(aligneds, pads):
        ext = conv_ops.conv2d(ext, a, padding=(0, pw), relu=relu,
                              policy=policy, mode=ConvMode.SCONV_PAR)
        m -= ph
        if m > 0:
            if idx == 0:
                ext[:, :m] = 0
            if idx == n - 1:
                ext[:, -m:] = 0
    return ext


def spatial_sconv_chain(x_local, aligneds: Sequence[AlignedConvWeight], *,
                        mesh, policy, axis_name: str = "model",
                        relu: bool = True):
    """A chain of stride-1 'same'-padded sparse convs with one halo
    exchange per layer and no duplicated margin: each conv of an odd kernel
    returns exactly the rank's rows."""
    pads = _odd_kernel_pads(aligneds)
    out = x_local
    for a, (ph, pw) in zip(aligneds, pads):
        ext = halo_exchange(out, ph, mesh, axis_name)
        out = conv_ops.conv2d(ext, a, padding=(0, pw), relu=relu,
                              policy=policy, mode=ConvMode.SCONV_PAR)
    return out
