"""Convolution with execution-mode dispatch (port of
``caffe_escoin_tpu/ops/conv.py``).

* LOWERED_GEMM   -> ``F.conv2d`` (cuDNN on the card).
* LOWERED_SPARSE -> im2col + SpMM: with ``sparse_format=ELL`` and the
                    ELL artifact aligned, the gather SpMM over the
                    row-sparse W^T (kernels/spmm.ell_spmm, torch ops, as
                    the JAX package's ``ops/conv.py:146-149``); else the
                    XBSP ``spmm`` (kernels/xla_block_sparse.py) with
                    ``use_xla_sparse``, else the SpMM kernel
                    (kernels/bsc_spmm.py).
* SCONV[_PAR]    -> with ``use_xla_sparse`` (the default), the JAX
                    package's default executor (its ``ops/conv.py:188-203,
                    256-312``): a strided 1x1 conv subsamples first, a
                    strided k>1 conv runs dense, and a stride-1 conv runs
                    the arm ``xla_block_sparse.best_arm`` picks ("unroll",
                    "gathered", "gathered_cols", "dense" on the pruned
                    weight, or "fused", the direct kernel); SCONV runs the
                    arm image by image, SCONV_PAR on the whole batch.
                    With ``use_xla_sparse=False``, the kernels' route (its
                    ``ops/conv.py:188-210, 314-381``): strided 1x1 convs
                    subsample first, strided k>1 convs run lowered, and a
                    stride-1 conv takes, in this order, the fused direct
                    kernel (kernels/sconv_fused.py), the SpMM for a 1x1
                    conv, the garbage-column direct kernel
                    (kernels/sconv_gc.py), or im2col + SpMM.

``conv_route`` names the route of a layer from shapes alone (with
autotune on, from the autotune cache), and ``conv2d`` dispatches through
it. A layer whose weight is denser than the policy's threshold runs dense.
Activations are NHWC and weights HWIO, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import (ConvMode, ExecutionPolicy,
                                                   SparseFormat)
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_fused, sconv_gc
from caffe_escoin_tpu_torch.kernels import spmm as spmm_kernels
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight


def _out_spatial(size, k, s, p, d):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def im2col(x, kernel, *, stride, padding, dilation):
    """Patch extraction in (kh, kw, c) column order: [N,Ho,Wo,KH*KW*C]."""
    n, h, w, c = x.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    ho = _out_spatial(h, kh, sh, ph, dh)
    wo = _out_spatial(w, kw, sw, pw, dw)
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    cols = [xp[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
               j * dw:j * dw + (wo - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1), (ho, wo)


def _epilogue(out, relu, residual=None):
    """Residual add and ReLU after a conv that applied neither. A
    two-operand bf16 add rounds once, so this equals adding in f32 and
    casting, as the fused kernel's epilogue does."""
    if residual is not None:
        out = out + residual.to(out.dtype)
    if relu:
        out = torch.relu(out)
    return out


def conv2d_dense(x, w_hwio, bias=None, *, stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, relu=False, residual=None):
    """Dense conv: the LOWERED_GEMM mode. NHWC in and out; internally a
    channels_last NCHW view for ``F.conv2d``."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.to(x.dtype).permute(3, 2, 0, 1),
                   None if bias is None else bias.to(x.dtype),
                   stride=tuple(stride), padding=tuple(padding),
                   dilation=tuple(dilation), groups=groups)
    out = out.permute(0, 2, 3, 1)
    return _epilogue(out, relu, residual).contiguous()


def conv2d_lowered_sparse(x, aligned: AlignedConvWeight, *, stride, padding,
                          dilation, relu, policy: ExecutionPolicy,
                          residual=None):
    """im2col + SpMM over the sparse GEMM-view weight: the ELL gather SpMM
    (``_uses_ell``; bias, residual and ReLU in f32 after it, then one cast
    to x's dtype), else the XBSP ``spmm`` with ``use_xla_sparse``, else the
    SpMM kernel (bias and ReLU in the SpMM's epilogue, the residual after
    it)."""
    kh, kw = aligned.kernel_shape
    cols, (ho, wo) = im2col(x, (kh, kw), stride=stride, padding=padding,
                            dilation=dilation)
    n = x.shape[0]
    cols2d = cols.reshape(n * ho * wo, kh * kw, aligned.cin)
    if aligned.cin_pad != aligned.cin:
        # the GEMM-view weight's channel padding, so K-blocks stay
        # offset-aligned
        cols2d = F.pad(cols2d, (0, aligned.cin_pad - aligned.cin))
    cols2d = cols2d.reshape(n * ho * wo, aligned.k)
    if _uses_ell(aligned, policy):
        # the reference's CSR orientation: rows are output channels
        out = spmm_kernels.ell_spmm(aligned.ell_t, cols2d.T).T
        if aligned.bias is not None:
            out = out + aligned.bias.float()
        out = out.reshape(n, ho, wo, aligned.cout)
        if residual is not None:
            out = out + residual.float()
        if relu:
            out = torch.relu(out)
        # out is still laid out as ell_spmm's [Cout, M]: one cast and
        # transpose
        return torch.empty_like(out, dtype=x.dtype,
                                memory_format=torch.contiguous_format
                                ).copy_(out)
    if xbs.spmm_supported(aligned.bsc, policy):
        out2d = xbs.spmm(cols2d, aligned.bsc, bias=aligned.bias,
                         relu=relu and residual is None)
    else:
        out2d = bsc_spmm.bsc_spmm(cols2d, aligned.bsc, bias=aligned.bias,
                                  relu=relu and residual is None,
                                  mxu_dtype=policy.mxu_dtype)
    out = out2d.reshape(n, ho, wo, aligned.cout)
    if residual is not None:
        out = _epilogue(out, relu, residual)
    return out


def _uses_ell(aligned: AlignedConvWeight, policy: ExecutionPolicy) -> bool:
    """LOWERED_SPARSE runs the ELL gather SpMM: the policy asks for ELL and
    the weight was aligned with it."""
    return (policy.sparse_format == SparseFormat.ELL
            and aligned.ell_t is not None)


# the kernel each conv route launches once per layer; the rest ("dense",
# the XBSP arms, "xbsp_lowered", "ell") launch none
ROUTE_KERNELS = {"fused": "sconv_fused", "gc": "sconv_gc",
                 "spmm_1x1": "bsc_spmm", "lowered": "bsc_spmm"}
# the XBSP arm functions by route name
XBSP_ARMS = {"unroll": xbs.conv, "gathered": xbs.conv_gathered,
             "gathered_cols": xbs.conv_gathered_cols}


def _subsampled(x, stride, padding):
    """A meta tensor of the map a strided 1x1 conv subsamples to."""
    n, h, w, c = x.shape
    return torch.empty((n, _out_spatial(h, 1, stride[0], padding[0], 1),
                        _out_spatial(w, 1, stride[1], padding[1], 1), c),
                       dtype=x.dtype, device="meta")


def _xbsp_route(x, aligned: AlignedConvWeight, stride, padding, dilation,
                policy: ExecutionPolicy) -> str:
    """The SCONV route of the JAX package's ``conv2d_sconv`` with
    ``use_xla_sparse`` (its ``ops/conv.py:188-203, 256-312``): "dense" for
    a strided k>1 conv, else the arm of ``best_arm``. A "fused" pick runs
    the kernel only where the reference's gate holds, the kernel's own
    limits and the TPU kernel's size budget (``sconv_fused.fits_budget``,
    part of the reference's ``supported``); elsewhere it runs the unroll,
    as there."""
    if stride != (1, 1):
        if aligned.kernel_shape == (1, 1) and dilation == (1, 1):
            return _xbsp_route(_subsampled(x, stride, padding), aligned,
                               (1, 1), (0, 0), (1, 1), policy)
        return "dense"
    arm = xbs.best_arm(aligned, policy, x_shape=tuple(x.shape), stride=stride,
                       padding=padding, dilation=dilation)
    if arm == "dense":
        return "dense"
    if (arm == "fused" and sconv_fused.supported(x, aligned,
                                                 dilation=dilation)
            and sconv_fused.fits_budget(x, aligned, padding)):
        return "fused"
    return arm if arm in XBSP_ARMS else "unroll"


def _sconv_route(x, aligned: AlignedConvWeight, stride, padding,
                 dilation) -> str:
    """The SCONV route of the JAX package's ``conv2d_sconv`` with
    ``use_xla_sparse=False``. Its two Pallas gates are size budgets of the
    TPU kernels, carried over (``sconv_fused.fits_budget``,
    ``sconv_gc.fits_budget``) so that each layer takes the same kernel on
    both sides; each kernel's ``supported`` adds its own limits."""
    if stride != (1, 1):
        if aligned.kernel_shape == (1, 1) and dilation == (1, 1):
            # routed as the stride-1 conv on the subsampled map
            return _sconv_route(_subsampled(x, stride, padding), aligned,
                                (1, 1), (0, 0), (1, 1))
        return "lowered"
    if dilation != (1, 1):
        return "lowered"
    if (sconv_fused.supported(x, aligned)
            and sconv_fused.fits_budget(x, aligned, padding)):
        return "fused"
    bk = aligned.bsc.block_shape[0]
    # the 1x1 gate keeps the TPU SpMM's alignment rule (bsc_pallas.py:43-47)
    if (aligned.kernel_shape == (1, 1) and padding == (0, 0)
            and (bk % 128 == 0 or aligned.bsc.n_brows == 1)):
        return "spmm_1x1"
    if sconv_gc.supported(x, aligned) and sconv_gc.fits_budget(x, aligned):
        return "gc"
    return "lowered"


def conv_route(x, aligned: AlignedConvWeight, *,
               stride: Tuple[int, int] = (1, 1),
               padding: Tuple[int, int] = (0, 0),
               dilation: Tuple[int, int] = (1, 1),
               mode: Optional[ConvMode] = None,
               policy: Optional[ExecutionPolicy] = None) -> str:
    """The route ``conv2d`` takes for this layer: in LOWERED_SPARSE "ell"
    (``sparse_format=ELL`` with the ELL artifact aligned), else
    "xbsp_lowered" with ``use_xla_sparse`` or "lowered" without; in SCONV
    with ``use_xla_sparse``, "dense" or an arm ("unroll", "gathered",
    "gathered_cols", "fused"); without, "dense", "lowered", "fused",
    "spmm_1x1" or "gc". A layer with no sparse artifact, or denser than
    the mode's threshold, runs "dense". ``x`` needs only ``shape`` and
    ``dtype`` (a meta tensor will do); its dtype is the activation's after any compute-dtype
    cast, since the size gates count its bytes and autotune's key holds
    its shape. With ``policy.autotune`` the arm comes from the autotune
    cache, and a key not in it yet is measured first on the weight's
    device."""
    policy = policy or ExecutionPolicy()
    mode = policy.conv_mode if mode is None else mode
    if mode == ConvMode.LOWERED_SPARSE:
        profitable = aligned.sparsity >= policy.sparse_threshold
    elif mode in (ConvMode.SCONV, ConvMode.SCONV_PAR):
        profitable = aligned.sparsity >= policy.sconv_threshold
    else:
        profitable = False
    sparse_ready = aligned.bsc is not None or aligned.ell_t is not None
    if mode == ConvMode.LOWERED_GEMM or not sparse_ready or not profitable:
        return "dense"
    stride, padding, dilation = tuple(stride), tuple(padding), tuple(dilation)
    if mode == ConvMode.LOWERED_SPARSE:
        if _uses_ell(aligned, policy):
            return "ell"
        return ("xbsp_lowered" if xbs.spmm_supported(aligned.bsc, policy)
                else "lowered")
    if xbs.supported(aligned, policy):
        return _xbsp_route(x, aligned, stride, padding, dilation, policy)
    return _sconv_route(x, aligned, stride, padding, dilation)


def _subsample_1x1(x, stride, padding):
    """A 1x1 conv commutes with its stride: pad, then keep every stride-th
    pixel, so that the stride-1 route runs on the smaller map."""
    if padding != (0, 0):
        x = F.pad(x, (0, 0, padding[1], padding[1], padding[0], padding[0]))
    return x[:, ::stride[0], ::stride[1], :].contiguous()


def _run_xbsp(conv_fn, x, aligned: AlignedConvWeight, *, padding, dilation,
              relu, residual, batch_parallel: bool):
    """One stride-1 XBSP arm: on the whole batch (SCONV_PAR), or image by
    image with each image's residual (SCONV, the reference's per-image
    ``forward_gpu_sconv``)."""
    def one(y, res):
        return conv_fn(y, aligned, padding=padding, dilation=dilation,
                       relu=relu, residual=res)

    if batch_parallel or x.shape[0] == 1:
        return one(x, residual)
    return torch.cat([one(x[i:i + 1],
                          None if residual is None else residual[i:i + 1])
                      for i in range(x.shape[0])])


def _run_route(route, x, aligned: AlignedConvWeight, *, stride, padding,
               dilation, relu, policy: ExecutionPolicy, residual,
               batch_parallel: bool = True):
    """Runs one conv on the route ``conv_route`` named for it."""
    if route == "dense":
        return conv2d_dense(
            x, aligned.dense, aligned.bias, stride=stride, padding=padding,
            dilation=dilation, groups=aligned.groups, relu=relu,
            residual=residual)
    if route in ("lowered", "xbsp_lowered", "ell"):
        return conv2d_lowered_sparse(
            x, aligned, stride=stride, padding=padding, dilation=dilation,
            relu=relu, policy=policy, residual=residual)
    if stride != (1, 1):  # only a 1x1 conv takes a direct route strided
        x, padding = _subsample_1x1(x, stride, padding), (0, 0)
    if route == "fused":
        return sconv_fused.sconv(x, aligned, padding=padding, relu=relu,
                                 residual=residual, mxu_dtype=policy.mxu_dtype)
    if route in XBSP_ARMS:
        return _run_xbsp(XBSP_ARMS[route], x, aligned, padding=padding,
                         dilation=dilation, relu=relu, residual=residual,
                         batch_parallel=batch_parallel)
    if route == "spmm_1x1":
        # a 1x1 conv is the SpMM itself: the batch folds into M
        n, h, w, c = x.shape
        x2d = x.reshape(n * h * w, c)
        if aligned.cin_pad != aligned.cin:
            x2d = F.pad(x2d, (0, aligned.cin_pad - aligned.cin))
        out2d = bsc_spmm.bsc_spmm(x2d, aligned.bsc, bias=aligned.bias,
                                  relu=relu and residual is None,
                                  mxu_dtype=policy.mxu_dtype)
        out = out2d.reshape(n, h, w, aligned.cout)
    else:  # "gc"
        out = sconv_gc.sconv(x, aligned, padding=padding,
                             relu=relu and residual is None,
                             mxu_dtype=policy.mxu_dtype)
    if residual is not None:
        out = _epilogue(out, relu, residual)
    return out


def conv2d_sconv(x, aligned: AlignedConvWeight, *, stride, padding, dilation,
                 relu, policy: ExecutionPolicy, batch_parallel: bool = True,
                 residual=None):
    """Direct sparse convolution, whatever the weight's sparsity: the XBSP
    arms with ``use_xla_sparse``, else the kernels' route (the JAX
    package's ``ops/conv.py:167-381``)."""
    stride, padding, dilation = tuple(stride), tuple(padding), tuple(dilation)
    if xbs.supported(aligned, policy):
        route = _xbsp_route(x, aligned, stride, padding, dilation, policy)
    else:
        route = _sconv_route(x, aligned, stride, padding, dilation)
    return _run_route(route, x, aligned, stride=stride, padding=padding,
                      dilation=dilation, relu=relu, policy=policy,
                      residual=residual, batch_parallel=batch_parallel)


def conv2d(x, aligned: AlignedConvWeight, *,
           stride: Tuple[int, int] = (1, 1),
           padding: Tuple[int, int] = (0, 0),
           dilation: Tuple[int, int] = (1, 1), relu: bool = False,
           mode: Optional[ConvMode] = None,
           policy: Optional[ExecutionPolicy] = None, residual=None):
    """Mode-dispatched convolution over an aligned weight: runs the route
    ``conv_route`` names."""
    policy = policy or ExecutionPolicy()
    mode = policy.conv_mode if mode is None else mode
    stride, padding, dilation = tuple(stride), tuple(padding), tuple(dilation)
    route = conv_route(x, aligned, stride=stride, padding=padding,
                       dilation=dilation, mode=mode, policy=policy)
    return _run_route(route, x, aligned, stride=stride, padding=padding,
                      dilation=dilation, relu=relu, policy=policy,
                      residual=residual,
                      batch_parallel=(mode == ConvMode.SCONV_PAR))
