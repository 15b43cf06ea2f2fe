"""Convolution with execution-mode dispatch (port of
``caffe_escoin_tpu/ops/conv.py``).

* LOWERED_GEMM   -> a bf16 stem (Cin <= 4) in one pass of
                    kernels/stem_conv.py; any other conv ``F.conv2d``
                    (cuDNN on the card), then the bias, residual and
                    ReLU in one pass of kernels/conv_epilogue.py.
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
                    the arm ``best_arm`` picks ("unroll", "gathered",
                    "gathered_cols", "dense" on the pruned weight, or
                    "fused", the direct kernel); SCONV runs the arm image
                    by image, SCONV_PAR on the whole batch.
                    With ``use_xla_sparse=False``, the kernels' route (its
                    ``ops/conv.py:188-210, 314-381``): strided 1x1 convs
                    subsample first, strided k>1 convs run lowered, and a
                    stride-1 conv takes, in this order, the fused direct
                    kernel (kernels/sconv_fused.py), the SpMM for a 1x1
                    conv, the garbage-column direct kernel
                    (kernels/sconv_gc.py), or im2col + SpMM.
                    With ``native_cpu``, on a CPU tensor, where the XBSP
                    branch would run a stride-1 (or strided 1x1) conv of
                    dilation 1, the host C++ direct conv runs instead
                    (``csrc/sconv.cc`` through data/native.py; the JAX
                    package's ``ops/conv.py:212-254``).

This module owns the choice of kernel. ``conv_route`` names the route of
a layer from shapes alone, and ``conv2d`` dispatches through it; the native
host route depends on the tensor's device, so it is taken at run time and
never named. A layer whose weight is denser than the policy's threshold
runs dense. With autotune on, ``conv_arms`` names what competes and
engine/autotune.py only measures it and caches the winner.
Activations are NHWC and weights HWIO, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine import autotune
from caffe_escoin_tpu_torch.engine.context import (ConvMode, ExecutionPolicy,
                                                   SparseFormat)
from caffe_escoin_tpu_torch.kernels import (bsc_spmm, conv_epilogue,
                                            sconv_fused, sconv_gc, stem_conv)
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


def runs_stem(x, w_hwio, bias=None, *, stride=(1, 1), padding=(0, 0),
              dilation=(1, 1), groups=1, residual=False) -> bool:
    """Whether ``conv2d_dense`` runs this conv on the stem kernel
    (``kernels/stem_conv.takes``: a bf16 image of at most 4 channels, no
    residual, no autograd graph). ``x`` needs only shape and dtype."""
    return stem_conv.takes(x, w_hwio, bias, stride=stride, padding=padding,
                           dilation=dilation, groups=groups,
                           residual=residual)


def conv2d_dense(x, w_hwio, bias=None, *, stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, relu=False, residual=None,
                 memo=None):
    """Dense conv: the LOWERED_GEMM mode. NHWC in and out. Where
    ``runs_stem`` holds, one entry of ``kernels/stem_conv`` (the conv, its
    bias and ReLU in one pass; its weight layout kept in ``memo``, an
    aligned weight's, where one is given). Elsewhere ``F.conv2d`` on a
    channels_last NCHW view, and its bias, residual and ReLU are one entry
    of ``kernels/conv_epilogue``: where that launches its kernel
    (``takes_kernel``) cuDNN adds no bias and the kernel adds it with the
    rest in one pass; elsewhere ``F.conv2d`` adds it and the entry's plain
    version runs the rest. A conv with none of the three calls no
    epilogue entry."""
    if runs_stem(x, w_hwio, bias, stride=stride, padding=padding,
                 dilation=dilation, groups=groups,
                 residual=residual is not None):
        return stem_conv.stem_conv(x, w_hwio, bias, stride=stride,
                                   padding=padding, relu=relu, memo=memo)
    b = None if bias is None else bias.to(x.dtype)
    kernel = conv_epilogue.takes_kernel(x, w_hwio, b, residual)
    out = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.to(x.dtype).permute(3, 2, 0, 1),
                   None if kernel else b, stride=tuple(stride),
                   padding=tuple(padding), dilation=tuple(dilation),
                   groups=groups)
    out = out.permute(0, 2, 3, 1)
    if b is None and not relu and residual is None:
        return out.contiguous()
    return conv_epilogue.conv_epilogue(out, b if kernel else None, relu=relu,
                                       residual=residual)


_CONV_ND = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def convnd_dense(x, w, bias=None, *, stride=None, padding=None,
                 dilation=None, groups=1, relu=False):
    """Dense N-D convolution, 1 to 3 spatial dims (the reference's
    ``im2col_nd_*`` path, `src/caffe/util/im2col.cpp:141+`; the JAX
    package's ``convnd_dense``, ``ops/conv.py:101-125``). x: [N, *S, Cin],
    w: [*K, Cin/g, Cout] -> [N, *So, Cout]. Sparse execution stays 2-D."""
    nsp = x.dim() - 2
    if w.dim() != nsp + 2:
        raise ValueError(f"weight rank {w.dim()} does not match input "
                         f"spatial rank {nsp}")
    if nsp not in _CONV_ND:
        raise ValueError(f"{nsp}-D convolution: torch convolves 1-3 spatial "
                         f"dims")
    out = _CONV_ND[nsp](
        x.movedim(-1, 1), w.to(x.dtype).permute(nsp + 1, nsp,
                                                *range(nsp)),
        None if bias is None else bias.to(x.dtype),
        stride=tuple(stride or (1,) * nsp),
        padding=tuple(padding or (0,) * nsp),
        dilation=tuple(dilation or (1,) * nsp), groups=groups)
    return conv_epilogue.epilogue_plain(out.movedim(1, -1), relu=relu)


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
        out = conv_epilogue.epilogue_plain(out, relu=relu, residual=residual)
    return out


def _uses_ell(aligned: AlignedConvWeight, policy: ExecutionPolicy) -> bool:
    """LOWERED_SPARSE runs the ELL gather SpMM: the policy asks for ELL and
    the weight was aligned with it."""
    return (policy.sparse_format == SparseFormat.ELL
            and aligned.ell_t is not None)


# the hand kernel each conv or fc route launches once ("spmm" is the fc's);
# the rest launch none
ROUTE_KERNELS = {"fused": "sconv_fused", "gc": "sconv_gc",
                 "spmm_1x1": "bsc_spmm", "lowered": "bsc_spmm",
                 "spmm": "bsc_spmm"}


def route_launches(route: Optional[str]) -> Dict[str, int]:
    """The hand-kernel launches of one conv or fc on ``route``, by kernel
    module: its kernel's one, or none."""
    kernel = ROUTE_KERNELS.get(route)
    return {kernel: 1} if kernel else {}


def conv_launches(route: Optional[str], *, epilogue: bool,
                  stem: bool = False) -> Dict[str, int]:
    """The hand-kernel launches of one 2-D conv on ``route``: its route
    kernel's; on the "dense" route the stem kernel's where ``conv2d_dense``
    takes it (``stem``: ``runs_stem``), else the epilogue kernel's where
    the conv has a bias, a ReLU or a residual (``epilogue``)."""
    if route == "dense":
        if stem:
            return {"stem_conv": 1}
        return {"conv_epilogue": 1} if epilogue else {}
    return route_launches(route)


# the XBSP arm functions by route name
XBSP_ARMS = {"unroll": xbs.conv, "gathered": xbs.conv_gathered,
             "gathered_cols": xbs.conv_gathered_cols}


def fused_gate(x, aligned: AlignedConvWeight, padding, *, stride=(1, 1),
               dilation=(1, 1)) -> bool:
    """The fused kernel's one gate, for routes and candidates alike: its
    own limits (``sconv_fused.supported``) and the TPU kernel's size
    budget (``sconv_fused.fits_budget``, part of the reference's
    ``supported``). ``x`` needs only ``shape`` and ``dtype``."""
    return (sconv_fused.supported(x, aligned, stride=stride,
                                  dilation=dilation)
            and sconv_fused.fits_budget(x, aligned, padding))


def conv_arms(x, aligned: AlignedConvWeight, *, stride, padding, dilation,
              policy: ExecutionPolicy) -> Dict[str, Callable]:
    """A conv's candidates (the router asks at stride 1), callables of the
    input with neither ReLU nor residual, in this order: "unroll",
    "gathered", "gathered_cols", "dense" (the pruned weight cast once to
    x's dtype), then "fused" where ``fused_gate`` admits the shape."""
    geo = dict(stride=stride, padding=padding, dilation=dilation)
    wd = aligned.dense.to(x.dtype)
    arms = {
        "unroll": lambda y: xbs.conv(y, aligned, **geo),
        "gathered": lambda y: xbs.conv_gathered(y, aligned, **geo),
        "gathered_cols": lambda y: xbs.conv_gathered_cols(y, aligned, **geo),
        "dense": lambda y: conv2d_dense(y, wd, aligned.bias,
                                        groups=aligned.groups, **geo),
    }
    if fused_gate(x, aligned, padding, stride=stride, dilation=dilation):
        arms["fused"] = lambda y: sconv_fused.sconv(
            y, aligned, padding=padding, relu=False,
            mxu_dtype=policy.mxu_dtype)
    return arms


def measured_arm(aligned: AlignedConvWeight, policy, x_shape, stride,
                 padding, dilation, *, log=None) -> Optional[str]:
    """``autotune.choose`` of ``conv_arms`` under ``autotune.cache_key``:
    the cached winner for this (shape, pattern), or measured now; None
    when called re-entrantly from inside a measurement."""
    dtype = policy.compute_dtype or torch.float32
    x = torch.empty(tuple(x_shape), dtype=dtype, device="meta")
    return autotune.choose(
        autotune.cache_key(aligned, x_shape, stride, padding, dilation,
                           dtype, getattr(policy, "mxu_dtype", "auto")),
        kind="conv",
        what=f"{tuple(x_shape)} k{aligned.kernel_shape} cout{aligned.cout}",
        policy=policy, weight=aligned.bsc, x_shape=x_shape, dtype=dtype,
        candidates=functools.partial(conv_arms, x, aligned, stride=stride,
                                     padding=padding, dilation=dilation,
                                     policy=policy),
        log=log)


def best_arm(aligned: AlignedConvWeight, policy, *, x_shape=None,
             stride=(1, 1), padding=(0, 0), dilation=(1, 1)) -> str:
    """Per-shape arm: "unroll", "gathered", "gathered_cols", "dense" or
    "fused". The JAX package's rule, unchanged (its
    ``kernels/xla_block_sparse.best_arm``):

    * a forced ``policy.xbsp_arm`` wins;
    * more than half the blocks live: "dense" (block-density
      profitability, before autotune: isolated measurement keeps weights
      cache-warm and flatters many small products);
    * with ``policy.autotune`` and an input shape: the measured winner
      (``measured_arm``), when it can measure;
    * a quarter or more of the blocks live: "dense" (the heuristic never
      lose floor);
    * k>1 or a reduce 1x1 (cout <= cin): "unroll";
    * an expand 1x1 whose union covers all of K with cin >= 128: "dense";
      else "gathered".
    """
    arm = getattr(policy, "xbsp_arm", "auto")
    if arm != "auto":
        return arm
    if aligned.block_density > 0.5:
        return "dense"
    if getattr(policy, "autotune", False) and x_shape is not None:
        got = measured_arm(aligned, policy, x_shape, stride, padding,
                           dilation)
        if got is not None:
            return got
    if aligned.block_density >= 0.25:
        return "dense"
    kh, kw = aligned.kernel_shape
    if not (kh == kw == 1 and aligned.cout > aligned.cin):
        return "unroll"
    if aligned.cin >= 128 and xbs.union_live_fraction(aligned) >= 1.0:
        return "dense"
    return "gathered"


def _subsampled(x, stride, padding):
    """A meta tensor of the map a strided 1x1 conv subsamples to."""
    n, h, w, c = x.shape
    return torch.empty((n, _out_spatial(h, 1, stride[0], padding[0], 1),
                        _out_spatial(w, 1, stride[1], padding[1], 1), c),
                       dtype=x.dtype, device="meta")


def _xbsp_route(x, aligned: AlignedConvWeight, padding, dilation,
                policy: ExecutionPolicy) -> str:
    """A stride-1 conv's SCONV route in the JAX package's ``conv2d_sconv``
    with ``use_xla_sparse`` (its ``ops/conv.py:188-203, 256-312``): the arm
    of ``best_arm``. A "fused" pick runs the kernel only where
    ``fused_gate`` admits the shape; elsewhere it runs the unroll, as
    there."""
    arm = best_arm(aligned, policy, x_shape=tuple(x.shape), padding=padding,
                   dilation=dilation)
    if arm == "dense":
        return "dense"
    if arm == "fused" and fused_gate(x, aligned, padding, dilation=dilation):
        return "fused"
    return arm if arm in XBSP_ARMS else "unroll"


def _kernel_route(x, aligned: AlignedConvWeight, padding, dilation) -> str:
    """A stride-1 conv's SCONV route in the JAX package's ``conv2d_sconv``
    with ``use_xla_sparse=False``. Its two Pallas gates are size budgets of
    the TPU kernels, carried over (``fused_gate``, ``sconv_gc.fits_budget``)
    so that each layer takes the same kernel on both sides; each kernel's
    ``supported`` adds its own limits."""
    if dilation != (1, 1):
        return "lowered"
    if fused_gate(x, aligned, padding):
        return "fused"
    bk = aligned.bsc.block_shape[0]
    # the 1x1 gate keeps the TPU SpMM's alignment rule (bsc_pallas.py:43-47)
    if (aligned.kernel_shape == (1, 1) and padding == (0, 0)
            and (bk % 128 == 0 or aligned.bsc.n_brows == 1)):
        return "spmm_1x1"
    if sconv_gc.supported(x, aligned) and sconv_gc.fits_budget(x, aligned):
        return "gc"
    return "lowered"


def _sconv_route(x, aligned: AlignedConvWeight, stride, padding, dilation,
                 policy: ExecutionPolicy) -> str:
    """The SCONV route: the XBSP branch's where ``xbs.supported``, else
    the kernels'. A strided 1x1 conv is routed as the stride-1 conv on the
    map it subsamples; another strided conv runs "dense" on the XBSP
    branch and "lowered" on the kernels'."""
    xbsp = xbs.supported(aligned, policy)
    if stride != (1, 1):
        if aligned.kernel_shape == (1, 1) and dilation == (1, 1):
            return _sconv_route(_subsampled(x, stride, padding), aligned,
                                (1, 1), (0, 0), (1, 1), policy)
        return "dense" if xbsp else "lowered"
    if xbsp:
        return _xbsp_route(x, aligned, padding, dilation, policy)
    return _kernel_route(x, aligned, padding, dilation)


def _runs_sparse(aligned: AlignedConvWeight, policy: ExecutionPolicy,
                 mode: ConvMode) -> bool:
    """A sparse mode, a sparse artifact aligned, and the weight at least as
    sparse as the mode's threshold; else the conv runs dense."""
    if mode == ConvMode.LOWERED_SPARSE:
        threshold = policy.sparse_threshold
    elif mode in (ConvMode.SCONV, ConvMode.SCONV_PAR):
        threshold = policy.sconv_threshold
    else:
        return False
    return ((aligned.bsc is not None or aligned.ell_t is not None)
            and aligned.sparsity >= threshold)


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
    if not _runs_sparse(aligned, policy, mode):
        return "dense"
    stride, padding, dilation = tuple(stride), tuple(padding), tuple(dilation)
    if mode == ConvMode.LOWERED_SPARSE:
        if _uses_ell(aligned, policy):
            return "ell"
        return ("xbsp_lowered" if xbs.spmm_supported(aligned.bsc, policy)
                else "lowered")
    return _sconv_route(x, aligned, stride, padding, dilation, policy)


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
            residual=residual, memo=aligned.memo)
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
        out = conv_epilogue.epilogue_plain(out, relu=relu, residual=residual)
    return out


def _native_ok(x, aligned: AlignedConvWeight, stride, dilation,
               policy: ExecutionPolicy) -> bool:
    """The JAX package's gate of its native host route (``ops/conv.py:
    212-221``): ``native_cpu`` on a CPU tensor, dilation 1, a BSC under the
    XBSP branch, a conv the stride block leaves to the sparse route (stride
    1, or a 1x1 conv it subsamples), and the native library built."""
    if not (policy.native_cpu and x.device.type == "cpu"
            and dilation == (1, 1) and xbs.supported(aligned, policy)
            and (stride == (1, 1) or aligned.kernel_shape == (1, 1))):
        return False
    from caffe_escoin_tpu_torch.data import native

    return native.load_library() is not None


def _run_native(x, aligned: AlignedConvWeight, *, stride, padding, relu,
                residual):
    """The host direct conv (csrc/sconv.cc) on x's numpy view in f32. The
    residual add comes before the ReLU, so with a residual the kernel runs
    without ReLU and the add and ReLU follow in f32; then one cast to x's
    dtype. No autograd: the result is a new leaf."""
    from caffe_escoin_tpu_torch.data import native

    if stride != (1, 1):
        x, padding = _subsample_1x1(x, stride, padding), (0, 0)
    out = native.native_bsc_sconv(
        x.detach().float().numpy(), aligned, padding=padding,
        relu=relu and residual is None)
    if out is None:
        raise RuntimeError("native bsc_sconv failed")
    out = torch.from_numpy(out)
    if residual is not None:
        out = conv_epilogue.epilogue_plain(out, relu=relu,
                                           residual=residual.float())
    return out.to(x.dtype)


def conv2d_sconv(x, aligned: AlignedConvWeight, *, stride, padding, dilation,
                 relu, policy: ExecutionPolicy, batch_parallel: bool = True,
                 residual=None):
    """Direct sparse convolution, whatever the weight's sparsity: the native
    host route where ``_native_ok``, else the route ``_sconv_route`` names
    (the JAX package's ``ops/conv.py:167-381``)."""
    stride, padding, dilation = tuple(stride), tuple(padding), tuple(dilation)
    if _native_ok(x, aligned, stride, dilation, policy):
        return _run_native(x, aligned, stride=stride, padding=padding,
                           relu=relu, residual=residual)
    route = _sconv_route(x, aligned, stride, padding, dilation, policy)
    return _run_route(route, x, aligned, stride=stride, padding=padding,
                      dilation=dilation, relu=relu, policy=policy,
                      residual=residual, batch_parallel=batch_parallel)


def conv2d(x, aligned: AlignedConvWeight, *,
           stride: Tuple[int, int] = (1, 1),
           padding: Tuple[int, int] = (0, 0),
           dilation: Tuple[int, int] = (1, 1), relu: bool = False,
           mode: Optional[ConvMode] = None,
           policy: Optional[ExecutionPolicy] = None, residual=None):
    """Mode-dispatched convolution over an aligned weight: a sparse SCONV
    conv through ``conv2d_sconv``, image by image in SCONV; else the route
    ``conv_route`` names."""
    policy = policy or ExecutionPolicy()
    mode = policy.conv_mode if mode is None else mode
    if (mode in (ConvMode.SCONV, ConvMode.SCONV_PAR)
            and _runs_sparse(aligned, policy, mode)):
        return conv2d_sconv(x, aligned, stride=stride, padding=padding,
                            dilation=dilation, relu=relu, policy=policy,
                            batch_parallel=(mode == ConvMode.SCONV_PAR),
                            residual=residual)
    stride, padding, dilation = tuple(stride), tuple(padding), tuple(dilation)
    route = conv_route(x, aligned, stride=stride, padding=padding,
                       dilation=dilation, mode=mode, policy=policy)
    return _run_route(route, x, aligned, stride=stride, padding=padding,
                      dilation=dilation, relu=relu, policy=policy,
                      residual=residual)
