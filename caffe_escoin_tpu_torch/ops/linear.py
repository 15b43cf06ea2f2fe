"""Inner product with an optional sparse weight (port of
``caffe_escoin_tpu/ops/linear.py``). The fc's whole choice of arm lives
here: ``runs_sparse``, ``fc_arms``, ``fc_arm`` and ``fc_route``."""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine import autotune
from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import bsc_spmm
from caffe_escoin_tpu_torch.kernels import spmm as spmm_kernels
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.sparse.formats import BSC, ELL
from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight


def linear(x, w, bias=None, *, relu=False):
    """x: [..., K] @ w: [K, M] (+ bias[M])."""
    out = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    if relu:
        out = torch.relu(out)
    return out


def fc_arms(sparse_w: BSC, policy: ExecutionPolicy):
    """The arms that run a BSC fc under ``policy``, as autotune measures
    them: the XBSP ``spmm`` (where ``spmm_supported``), the ``bsc_spmm``
    kernel, and the dense matmul."""
    sparse = ("xbsp_spmm",) if xbs.spmm_supported(sparse_w, policy) else ()
    return sparse + ("bsc_spmm", "dense")


def run_fc_arm(arm: str, x2d, *, sparse_w: BSC, bias, relu: bool,
               policy: ExecutionPolicy, dense=None):
    """x2d [M, K] through one fc arm: "xbsp_spmm" (one product per live
    block), "bsc_spmm" (the SpMM kernel; both with bias and ReLU in f32) or
    "dense" (one matmul on ``dense`` [K', N] over x2d's first K' columns,
    K' <= K: the weight without the BSC's padding)."""
    if arm == "xbsp_spmm":
        return xbs.spmm(x2d, sparse_w, bias=bias, relu=relu)
    if arm == "bsc_spmm":
        return bsc_spmm.bsc_spmm(x2d, sparse_w, bias=bias, relu=relu,
                                 mxu_dtype=policy.mxu_dtype)
    if arm == "dense":
        return linear(x2d[:, :dense.shape[0]], dense, bias, relu=relu)
    raise ValueError(f"unknown fc arm {arm!r}")


def fc_arm(sparse_w: BSC, policy: ExecutionPolicy, rows: int, *, bias=None,
           relu=False, dense=None) -> str:
    """The arm ``linear_sparse`` runs for ``rows`` input rows: with
    ``policy.autotune`` (no forced ``xbsp_arm``) and a dense weight to
    offer, the measured winner of ``fc_arms`` (``autotune.choose`` under
    ``autotune.fc_cache_key``); else the JAX package's rule, the XBSP
    ``spmm`` under ``use_xla_sparse`` and the SpMM kernel without."""
    if policy.autotune and policy.xbsp_arm == "auto" and dense is not None:
        dtype = policy.compute_dtype or torch.float32
        got = autotune.choose(
            autotune.fc_cache_key(sparse_w, rows, dtype,
                                  getattr(policy, "mxu_dtype", "auto")),
            kind=autotune.FC,
            what=f"fc {rows}x{sparse_w.shape[0]}->{sparse_w.shape[1]}",
            policy=policy, weight=sparse_w, x_shape=(rows, sparse_w.shape[0]),
            dtype=dtype, candidates=lambda: {
                arm: functools.partial(run_fc_arm, arm, sparse_w=sparse_w,
                                       bias=bias, relu=relu, policy=policy,
                                       dense=dense)
                for arm in fc_arms(sparse_w, policy)})
        if got is not None:
            return got
    return "xbsp_spmm" if xbs.spmm_supported(sparse_w, policy) else "bsc_spmm"


def runs_sparse(aligned, policy: ExecutionPolicy) -> bool:
    """Whether an InnerProduct over ``aligned`` runs sparse, by the JAX
    package's rule (its ``nn/layers.py:291-314``): a forced ``xbsp_arm``
    decides first ("dense" forces the dense matmul, any other arm the
    sparse one); else the block-density gate, as the conv dispatcher's,
    sends an element-sparse but block-dense pattern to the one dense
    matmul."""
    if (not isinstance(aligned, AlignedConvWeight) or aligned.bsc is None
            or policy.conv_mode == ConvMode.LOWERED_GEMM):
        return False
    if policy.xbsp_arm != "auto":
        return policy.xbsp_arm != "dense"
    return (aligned.sparsity >= policy.sparse_threshold
            and aligned.block_density <= 0.5)


def dense_weight(aligned):
    """An aligned fc's dense weight [K, N]."""
    return aligned.dense.reshape(-1, aligned.cout)


def fc_route(aligned, policy: ExecutionPolicy, rows: int, *,
             relu=False) -> str:
    """An InnerProduct's route for ``rows`` input rows: "dense" unless
    ``runs_sparse``, else ``fc_arm``'s pick ("bsc_spmm" named "spmm")."""
    if not runs_sparse(aligned, policy):
        return "dense"
    arm = fc_arm(aligned.bsc, policy, rows, bias=aligned.bias, relu=relu,
                 dense=dense_weight(aligned))
    return {"bsc_spmm": "spmm"}.get(arm, arm)


def linear_aligned(x2d, aligned, *, relu=False,
                   policy: ExecutionPolicy):
    """x2d [M, K] through the fc over ``aligned``: the dense matmul where
    ``runs_sparse`` says no, else ``linear_sparse`` on x2d padded to the
    BSC's K (its arm is the one ``fc_route`` names)."""
    if not runs_sparse(aligned, policy):
        return linear(x2d, dense_weight(aligned), aligned.bias, relu=relu)
    if aligned.cin_pad != aligned.cin:
        x2d = F.pad(x2d, (0, aligned.cin_pad - aligned.cin))
    return linear_sparse(x2d, aligned.bsc, aligned.bias, relu=relu,
                         policy=policy, dense=dense_weight(aligned))


def linear_sparse(x, sparse_w, bias=None, *, relu=False,
                  policy: Optional[ExecutionPolicy] = None, dense=None):
    """Sparse-weight FC. ``sparse_w`` is a BSC of W[K, M], run by the arm
    ``fc_arm`` picks (``dense`` [K, M] is the weight the dense arm
    multiplies, and autotune measures the arms only where it is given),
    bias and ReLU in its epilogue; or an ELL of W^T[M, K], run by the
    gather SpMM, then bias and ReLU in f32 and one cast to x's dtype."""
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
    arm = fc_arm(sparse_w, policy, x2d.shape[0], bias=bias, relu=relu,
                 dense=dense)
    out = run_fc_arm(arm, x2d, sparse_w=sparse_w, bias=bias, relu=relu,
                     policy=policy, dense=dense)
    return out.reshape(*lead, sparse_w.shape[1])
