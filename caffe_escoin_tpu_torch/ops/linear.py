"""Inner product with an optional sparse weight (port of
``caffe_escoin_tpu/ops/linear.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import bsc_spmm
from caffe_escoin_tpu_torch.kernels import spmm as spmm_kernels
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.sparse.formats import BSC, ELL


def linear(x, w, bias=None, *, relu=False):
    """x: [..., K] @ w: [K, M] (+ bias[M])."""
    out = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    if relu:
        out = torch.relu(out)
    return out


def linear_sparse(x, sparse_w, bias=None, *, relu=False,
                  policy: Optional[ExecutionPolicy] = None):
    """Sparse-weight FC. ``sparse_w`` is a BSC of W[K, M], run by the XBSP
    ``spmm`` (one product per live block) with ``use_xla_sparse``, else by
    the block-sparse SpMM kernel, bias and ReLU in f32; or an ELL of
    W^T[M, K], run by the gather SpMM, then bias and ReLU in f32 and one
    cast to x's dtype."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if isinstance(sparse_w, ELL):
        out = spmm_kernels.ell_spmm(sparse_w, x2d.T).T
        if bias is not None:
            out = out + bias.float()
        if relu:
            out = torch.relu(out)
        return out.to(x.dtype).reshape(*lead, sparse_w.shape[0])
    if not isinstance(sparse_w, BSC):
        raise TypeError(type(sparse_w))
    policy = policy or ExecutionPolicy()
    if xbs.spmm_supported(sparse_w, policy):
        out = xbs.spmm(x2d, sparse_w, bias=bias, relu=relu)
    else:
        out = bsc_spmm.bsc_spmm(x2d, sparse_w, bias=bias, relu=relu,
                                mxu_dtype=policy.mxu_dtype)
    return out.reshape(*lead, sparse_w.shape[1])
