"""Tensor parallelism: output-channel partitioning (port of
``caffe_escoin_tpu/parallel/tp.py``).

Two mechanisms, as in the JAX package:

* **Dense, whole net.** ``param_shardings`` places conv HWIO weights and
  FC (K, M) weights on their output-channel dim over ``model``, 1-D
  params likewise, the rest whole; ``local_params`` cuts this rank's
  slices. The JAX package jits the net and lets GSPMD insert the
  collectives; ``forward_sharded`` is what that inserts: each sharded conv
  or fc runs on its cout slice and the channels are all-gathered before
  the next layer.
* **Sparse.** ``tp_conv_lowered`` splits a BSC's block columns over
  ``model``: each rank runs the SpMM (kernels/bsc_spmm.py) on its
  contiguous block columns and the cout slices are all-gathered.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import bsc_spmm
from caffe_escoin_tpu_torch.ops.conv import im2col
from caffe_escoin_tpu_torch.parallel.mesh import (axis_group, axis_index,
                                                  axis_size, local_shard,
                                                  replicated)
from caffe_escoin_tpu_torch.sparse.formats import BSC
from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight


def param_shardings(params, mesh) -> Dict[str, Any]:
    """The placements (one per mesh dim) of every param leaf, by the JAX
    rule: on the ``model`` axis 4-D on dim 3 (HWIO conv weight), 2-D on
    dim 1 (FC (K, M)), 1-D on dim 0 (bias, BatchNorm stats), any other leaf
    whole; an ``AlignedConvWeight`` whole (its TP is ``tp_conv_lowered``).
    The JAX function also takes the net, which it does not read."""
    whole = replicated(mesh)

    def on_model(leaf):
        dims = {4: 3, 2: 1, 1: 0}
        if isinstance(leaf, torch.Tensor) and leaf.dim() in dims:
            return tuple(Shard(dims[leaf.dim()]) if a == "model"
                         else Replicate() for a in mesh.mesh_dim_names)
        return whole

    out = {}
    for name, p in params.items():
        if isinstance(p, AlignedConvWeight):
            out[name] = whole
        elif isinstance(p, dict):
            out[name] = {k: on_model(v) for k, v in p.items()}
        else:
            out[name] = on_model(p)
    return out


def local_params(params, shardings, mesh):
    """This rank's slices of ``params`` under ``shardings``."""
    def cut(leaf, placements):
        if isinstance(leaf, torch.Tensor):
            return local_shard(leaf, placements, mesh)
        return leaf

    out = {}
    for name, p in params.items():
        s = shardings[name]
        if isinstance(p, dict):
            out[name] = {k: cut(v, s[k]) for k, v in p.items()}
        else:
            out[name] = cut(p, s)
    return out


def _gather_last(t: torch.Tensor, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _gather_dim(t: torch.Tensor, d: int, n: int, group) -> torch.Tensor:
    return _gather_last(t.movedim(d, -1), n, group).movedim(-1, d)


def forward_sharded(net, local, inputs, mesh):
    """The net's inference forward (``Net.apply``) on this rank's param
    slices (``local``, from ``local_params`` under ``param_shardings``,
    whose placement a slice's rank implies): a Convolution or InnerProduct
    of one group whose weight is sharded runs on its cout slice, and its
    output channels are all-gathered; any other layer with a sharded param
    runs on the param all-gathered whole. Returns the final tops, whole on
    every rank."""
    n = axis_size(mesh, "model")
    group = axis_group(mesh, "model")
    model = mesh.mesh_dim_names.index("model")
    shardings = param_shardings(local, mesh)

    def hook(layer, lp):
        spec = layer.spec
        sh = shardings.get(spec.share_params or spec.name, {})
        dims = {k: s[model].dim for k, s in sh.items()
                if isinstance(s[model], Shard)}
        if n == 1 or not isinstance(lp, dict) or not dims:
            return lp, None
        if (spec.type in ("Convolution", "ConvolutionReLU", "InnerProduct")
                and spec.params.get("group", 1) == 1):
            return lp, lambda o: _gather_last(o, n, group)
        return {k: (_gather_dim(v, dims[k], n, group) if k in dims else v)
                for k, v in lp.items()}, None

    with torch.inference_mode():
        return net.apply(local, inputs, layer_hook=hook)


def shard_bsc_cout(bsc: BSC, n_dev: int) -> int:
    """The number of block columns each of ``n_dev`` ranks holds; the
    block columns must divide evenly (pad cout at weight-align time)."""
    if bsc.n_bcols % n_dev != 0:
        raise ValueError(
            f"n_bcols {bsc.n_bcols} not divisible by model axis {n_dev}")
    return bsc.n_bcols // n_dev


def local_bsc(bsc: BSC, j0: int, j1: int) -> BSC:
    """Block columns [j0, j1) of ``bsc`` as a BSC of their own, with the
    host copies (``nnz_blocks``, the pattern) of those columns alone: the
    launch plan and the routing gates read them, so the whole matrix's must
    not ride along (as ``dataclasses.replace`` would keep them)."""
    row_np, nnz_np = bsc.pattern()
    return BSC(blocks=bsc.blocks[j0:j1], block_row=bsc.block_row[j0:j1],
               bcol_nnz=bsc.bcol_nnz[j0:j1],
               shape=(bsc.shape[0], (j1 - j0) * bsc.block_shape[1]),
               block_shape=bsc.block_shape,
               nnz_blocks=int(nnz_np[j0:j1].sum()),
               block_row_np=row_np[j0:j1], bcol_nnz_np=nnz_np[j0:j1])


def tp_conv_lowered(x, aligned: AlignedConvWeight, *, mesh,
                    stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                    relu: bool = False, policy=None,
                    axis_name: str = "model"):
    """Lowered sparse conv with the BSC's block columns split over
    ``axis_name``: x whole in on every rank of the axis; im2col (channels
    padded to ``cin_pad``), this rank's SpMM over its block columns with
    bias and ReLU in the kernel's epilogue, then an all-gather along cout.
    Returns [N, Ho, Wo, Cout], whole on every rank."""
    policy = policy or ExecutionPolicy()
    bsc = aligned.bsc
    n_dev = axis_size(mesh, axis_name)
    local_nb = shard_bsc_cout(bsc, n_dev)
    idx = axis_index(mesh, axis_name)
    bn = bsc.block_shape[1]
    kh, kw = aligned.kernel_shape
    cols, (ho, wo) = im2col(x, (kh, kw), stride=tuple(stride),
                            padding=tuple(padding), dilation=tuple(dilation))
    n = x.shape[0]
    cols2d = cols.reshape(n * ho * wo, kh * kw, aligned.cin)
    if aligned.cin_pad != aligned.cin:
        cols2d = F.pad(cols2d, (0, aligned.cin_pad - aligned.cin))
    cols2d = cols2d.reshape(n * ho * wo, aligned.k)
    bias = aligned.bias
    if bias is None:
        bias = torch.zeros(aligned.cout, dtype=torch.float32,
                           device=x.device)
    bias_p = F.pad(bias.float(), (0, bsc.n_bcols * bn - bias.shape[0]))
    j0, j1 = idx * local_nb, (idx + 1) * local_nb
    out = bsc_spmm.bsc_spmm(cols2d, local_bsc(bsc, j0, j1),
                            bias=bias_p[j0 * bn:j1 * bn], relu=relu,
                            mxu_dtype=policy.mxu_dtype)
    if n_dev > 1:
        out = _gather_last(out, n_dev, axis_group(mesh, axis_name))
    return out[:, :aligned.cout].reshape(n, ho, wo, aligned.cout)
