"""The layers of the slice (port of ``caffe_escoin_tpu/nn/layers.py``:
Input, Convolution, ConvolutionReLU, InnerProduct, Pooling, ReLU, Dropout,
Softmax, BatchNorm at global statistics, Scale, Eltwise). Convolution and
InnerProduct carry the sparse machinery (weight_align -> AlignedConvWeight
-> mode dispatch) and name the kernel route they take (``route``); the rest
are thin. The other registered types of the JAX package wait.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import ConvMode
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.nn.fillers import fill
from caffe_escoin_tpu_torch.nn.net import Layer, register_layer
from caffe_escoin_tpu_torch.ops import activations as act
from caffe_escoin_tpu_torch.ops import conv as conv_ops
from caffe_escoin_tpu_torch.ops import linear as linear_ops
from caffe_escoin_tpu_torch.ops import norm as norm_ops
from caffe_escoin_tpu_torch.ops import pool as pool_ops
from caffe_escoin_tpu_torch.ops import structural as struct_ops
from caffe_escoin_tpu_torch.sparse.weight_align import (AlignedConvWeight,
                                                        weight_align)


def _pair(v):
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return (v[0], v[0])
        return tuple(v)
    return (v, v)


def _cast(params, dtype):
    """A conv/fc layer's weights in the compute dtype (no copy when the
    caller already cast them, e.g. with nn.net.params_to)."""
    if isinstance(params, AlignedConvWeight):
        if params.dense.dtype == dtype and (
                params.bsc is None or params.bsc.blocks.dtype == dtype) and (
                params.ell_t is None or params.ell_t.values.dtype == dtype):
            return params
        return params.to(dtype=dtype)
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


@register_layer("Input")
class InputLayer(Layer):
    """Declares an externally fed blob."""

    def forward(self, params, inputs, state=None):
        return list(inputs)

    def out_shapes(self, in_shapes):
        return [tuple(s) for s in in_shapes]


@register_layer("Convolution")
class ConvolutionLayer(Layer):
    """Mode-dispatched 2-D conv. params keys: num_output, kernel, stride,
    pad, dilation, group, bias_term, weight_filler, bias_filler, fuse_relu,
    and fuse_add (set by nn/fuse.py: a second bottom is the residual)."""

    def _conf(self, in_shape):
        p = self.p
        if len(in_shape) != 4:
            raise ValueError(f"{self.spec.name}: only 2-D (NHWC) convolution "
                             f"is ported, got input shape {tuple(in_shape)}")
        return dict(kernel=_pair(p.get("kernel", 3)),
                    stride=_pair(p.get("stride", 1)),
                    pad=_pair(p.get("pad", 0)),
                    dilation=_pair(p.get("dilation", 1)),
                    groups=p.get("group", 1), cout=p["num_output"],
                    bias=p.get("bias_term", True), cin=in_shape[-1])

    def init_params(self, gen, in_shapes):
        c = self._conf(in_shapes[0])
        cin_g = c["cin"] // c["groups"]
        fan_in = math.prod(c["kernel"]) * cin_g
        params = {"w": fill(gen, c["kernel"] + (cin_g, c["cout"]),
                            self.p.get("weight_filler", {"type": "xavier"}),
                            fan_in=fan_in)}
        if c["bias"]:
            params["b"] = fill(gen, (c["cout"],),
                               self.p.get("bias_filler", {"type": "constant"}))
        return params

    def out_shapes(self, in_shapes):
        c = self._conf(in_shapes[0])
        n, h, w, _ = in_shapes[0]
        (kh, kw), (sh, sw) = c["kernel"], c["stride"]
        (ph, pw), (dh, dw) = c["pad"], c["dilation"]
        return [(n, conv_ops._out_spatial(h, kh, sh, ph, dh),
                 conv_ops._out_spatial(w, kw, sw, pw, dw), c["cout"])]

    def align(self, params):
        """``weight_align`` under the layer's policy: the BSC, and the ELL
        of W^T where the policy's ``sparse_format`` is ELL."""
        if isinstance(params, AlignedConvWeight):
            return params
        return weight_align(params["w"], params.get("b"),
                            groups=self.p.get("group", 1), policy=self.policy)

    def route(self, params, in_shapes, in_dtype):
        """``ops.conv.conv_route`` of this layer for an input of
        ``in_shapes[0]`` and ``in_dtype``, from shapes alone."""
        if not isinstance(params, AlignedConvWeight):
            return "dense"
        c = self._conf(in_shapes[0])
        x = torch.empty(in_shapes[0], dtype=self.policy.compute_dtype
                        or in_dtype, device="meta")
        return conv_ops.conv_route(x, params, stride=c["stride"],
                                   padding=c["pad"], dilation=c["dilation"],
                                   policy=self.policy)

    def forward(self, params, inputs, state=None):
        x = inputs[0]
        residual = (inputs[1] if len(inputs) > 1 and self.p.get("fuse_add")
                    else None)
        c = self._conf(x.shape)
        fuse_relu = self.p.get("fuse_relu", False) and self.policy.fuse_relu
        cd = self.policy.compute_dtype
        in_dtype = x.dtype
        if cd is not None:
            x = x.to(cd)
            params = _cast(params, cd)
            if residual is not None:
                residual = residual.to(cd)
        if isinstance(params, AlignedConvWeight):
            out = conv_ops.conv2d(x, params, stride=c["stride"],
                                  padding=c["pad"], dilation=c["dilation"],
                                  relu=fuse_relu, policy=self.policy,
                                  residual=residual)
        else:
            out = conv_ops.conv2d_dense(
                x, params["w"], params.get("b"), stride=c["stride"],
                padding=c["pad"], dilation=c["dilation"], groups=c["groups"],
                relu=fuse_relu, residual=residual)
        if cd is not None and self.policy.cast_back:
            out = out.to(in_dtype)
        return [out]


@register_layer("ConvolutionReLU")
class ConvolutionReLULayer(ConvolutionLayer):
    """Conv with ReLU fused into the kernel epilogue."""

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self.p["fuse_relu"] = True


# the kernel each ``Layer.route`` launches once per layer: the conv routes'
# kernels and the fc's SpMM ("dense" and the XBSP routes launch none)
ROUTE_KERNELS = {**conv_ops.ROUTE_KERNELS, "spmm": "bsc_spmm"}


@register_layer("InnerProduct")
class InnerProductLayer(Layer):
    """FC layer. Sparse execution runs a block-sparse SpMM over the 1x1
    GEMM-view AlignedConvWeight: the XBSP ``spmm`` with ``use_xla_sparse``,
    else the SpMM kernel."""

    def init_params(self, gen, in_shapes):
        k = math.prod(in_shapes[0][1:])
        m = self.p["num_output"]
        params = {"w": fill(gen, (k, m),
                            self.p.get("weight_filler", {"type": "xavier"}),
                            fan_in=k)}
        if self.p.get("bias_term", True):
            params["b"] = fill(gen, (m,),
                               self.p.get("bias_filler", {"type": "constant"}))
        return params

    def out_shapes(self, in_shapes):
        return [(in_shapes[0][0], self.p["num_output"])]

    def align(self, params):
        if isinstance(params, AlignedConvWeight):
            return params
        return weight_align(params["w"][None, None], params.get("b"),
                            policy=self.policy)

    def route(self, params, in_shapes=None, in_dtype=None):
        """"xbsp_spmm" (the XBSP unroll), "spmm" (the SpMM kernel, with
        ``use_xla_sparse=False``) or "dense", by the JAX package's rule
        (its ``nn/layers.py:291-314``): a forced ``xbsp_arm`` decides
        first ("dense" forces the dense matmul, any other arm the sparse
        one); else the block-density gate, as the conv dispatcher's, sends
        an element-sparse but block-dense pattern to the one dense
        matmul."""
        pol = self.policy
        if (not isinstance(params, AlignedConvWeight) or params.bsc is None
                or pol.conv_mode == ConvMode.LOWERED_GEMM):
            return "dense"
        if pol.xbsp_arm != "auto":
            sparse = pol.xbsp_arm != "dense"
        else:
            sparse = (params.sparsity >= pol.sparse_threshold
                      and params.block_density <= 0.5)
        if not sparse:
            return "dense"
        return "xbsp_spmm" if xbs.spmm_supported(params.bsc, pol) else "spmm"

    def forward(self, params, inputs, state=None):
        (x,) = inputs
        x2 = x.reshape(x.shape[0], -1)
        fuse_relu = self.p.get("fuse_relu", False) and self.policy.fuse_relu
        cd = self.policy.compute_dtype
        in_dtype = x.dtype
        if cd is not None:
            x2 = x2.to(cd)
            params = _cast(params, cd)
        if isinstance(params, AlignedConvWeight):
            aligned = params
            if self.route(aligned) != "dense":
                if aligned.cin_pad != aligned.cin:
                    x2 = F.pad(x2, (0, aligned.cin_pad - aligned.cin))
                out = linear_ops.linear_sparse(x2, aligned.bsc, aligned.bias,
                                               relu=fuse_relu,
                                               policy=self.policy)
            else:
                out = linear_ops.linear(x2, aligned.dense.reshape(-1, aligned.cout),
                                        aligned.bias, relu=fuse_relu)
        else:
            out = linear_ops.linear(x2, params["w"], params.get("b"),
                                    relu=fuse_relu)
        if cd is not None and self.policy.cast_back:
            out = out.to(in_dtype)
        return [out]


@register_layer("Pooling")
class PoolingLayer(Layer):
    def _args(self):
        p = self.p
        kernel = _pair(p.get("kernel", 2))
        return dict(kernel=kernel, stride=_pair(p.get("stride", kernel)),
                    padding=_pair(p.get("pad", 0)), mode=p.get("mode", "max"),
                    ceil_mode=p.get("ceil_mode", True))

    def out_shapes(self, in_shapes):
        n, h, w, c = in_shapes[0]
        if self.p.get("global_pooling", False):
            return [(n, 1, 1, c)]
        a = self._args()
        return [(n, pool_ops._pooled_size(h, a["kernel"][0], a["stride"][0],
                                          a["padding"][0], a["ceil_mode"]),
                 pool_ops._pooled_size(w, a["kernel"][1], a["stride"][1],
                                       a["padding"][1], a["ceil_mode"]), c)]

    def forward(self, params, inputs, state=None):
        (x,) = inputs
        if self.p.get("global_pooling", False):
            return [pool_ops.pool2d(x, (1, 1), mode=self.p.get("mode", "avg"),
                                    global_pool=True)]
        return [pool_ops.pool2d(x, **self._args())]


@register_layer("ReLU")
class ReLULayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.relu(inputs[0], self.p.get("negative_slope", 0.0))]


@register_layer("Dropout")
class DropoutLayer(Layer):
    """The identity at inference (the training forward is not ported)."""

    def forward(self, params, inputs, state=None):
        return [act.dropout(inputs[0], self.p.get("ratio", 0.5))]


@register_layer("Softmax")
class SoftmaxLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.softmax(inputs[0], self.p.get("axis", -1))]


@register_layer("BatchNorm")
class BatchNormLayer(Layer):
    """Caffe BatchNorm at global statistics. Its state holds the decayed
    sums ``mean_acc``/``var_acc`` and the normalisation ``count``; the
    forward divides the sums by ``count`` (count 0 -> mean 0, var 1). The
    training-mode forward waits for the training port."""

    has_state = True

    def init_state(self, in_shapes):
        c = in_shapes[0][-1]
        return {"mean_acc": torch.zeros(c), "var_acc": torch.zeros(c),
                "count": torch.zeros(())}

    def forward(self, params, inputs, state=None):
        (x,) = inputs
        if self.p.get("use_global_stats") is False:
            raise NotImplementedError(
                f"{self.spec.name}: batch-statistics BatchNorm (training) "
                f"is not ported")
        count = state["count"]
        inv_n = torch.where(count > 0, 1.0 / count.clamp_min(1e-30),
                            torch.zeros_like(count))
        mean = state["mean_acc"] * inv_n
        var = torch.where(count > 0, state["var_acc"] * inv_n,
                          torch.ones_like(state["var_acc"]))
        return [norm_ops.batch_norm_inference(x, mean, var,
                                              eps=self.p.get("eps", 1e-5))]


@register_layer("Scale")
class ScaleLayer(Layer):
    def init_params(self, gen, in_shapes):
        c = in_shapes[0][-1]
        params = {"gamma": torch.ones(c)}
        if self.p.get("bias_term", True):
            params["beta"] = torch.zeros(c)
        return params

    def forward(self, params, inputs, state=None):
        return [norm_ops.scale_bias(inputs[0], params["gamma"],
                                    params.get("beta"))]


@register_layer("Eltwise")
class EltwiseLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [struct_ops.eltwise(inputs, op=self.p.get("operation", "sum"),
                                   coeffs=self.p.get("coeffs"))]
