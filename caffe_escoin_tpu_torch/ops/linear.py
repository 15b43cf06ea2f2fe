"""Inner product with optional block-sparse weight (port of
``caffe_escoin_tpu/ops/linear.py``, BSC branch only)."""

from __future__ import annotations

from typing import Optional

import torch

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import bsc_spmm
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.sparse.formats import BSC


def linear(x, w, bias=None, *, relu=False):
    """x: [..., K] @ w: [K, M] (+ bias[M])."""
    out = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    if relu:
        out = torch.relu(out)
    return out


def linear_sparse(x, sparse_w: BSC, bias=None, *, relu=False,
                  policy: Optional[ExecutionPolicy] = None):
    """Sparse-weight FC over a BSC of W[K, M], bias and ReLU in f32: the
    XBSP ``spmm`` (one product per live block) with ``use_xla_sparse``,
    else the block-sparse SpMM kernel."""
    if not isinstance(sparse_w, BSC):
        raise TypeError(type(sparse_w))
    policy = policy or ExecutionPolicy()
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if xbs.spmm_supported(sparse_w, policy):
        out = xbs.spmm(x2d, sparse_w, bias=bias, relu=relu)
    else:
        out = bsc_spmm.bsc_spmm(x2d, sparse_w, bias=bias, relu=relu,
                                mxu_dtype=policy.mxu_dtype)
    return out.reshape(*lead, sparse_w.shape[1])
