"""The layers (port of ``caffe_escoin_tpu/nn/layers.py``: Input, the
convolutions (Convolution, ConvolutionReLU, EscConvolution), InnerProduct,
Pooling, the activations, Dropout, Softmax, BatchNorm, Scale, Bias, MVN,
LRN, the structural layers, DummyData, Accuracy, the seven losses,
Deconvolution, SPP, Im2col, RNN, LSTM, LSTMUnit, Embed, BatchReindex,
Filter, Parameter and Python; the data layers are in nn/data_layers.py).
Dropout, stochastic Pooling and BatchNorm have a training forward
(``train=True``, which ``Net.forward`` passes them): Dropout and stochastic
pooling draw from a generator, and BatchNorm normalizes by the batch
statistics and returns its new moving averages.
Convolution and InnerProduct carry the sparse machinery (weight_align ->
AlignedConvWeight -> mode dispatch) and name the kernel route they take
(``route``). Convolution, Pooling and LRN also run on the W-pair packed
layout that nn/fuse.pack_narrow_chains marks, and Convolution on the
space-to-depth layout that nn/fuse.fold_stem_s2d gives a stem; a
Convolution of another spatial rank (1-D, 3-D) runs dense. The rest are
thin. ``category`` is the timing bucket (utils/timing.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import ConvMode
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.nn.fillers import fill
from caffe_escoin_tpu_torch.nn.net import Layer, register_layer
from caffe_escoin_tpu_torch.ops import activations as act
from caffe_escoin_tpu_torch.ops import conv as conv_ops
from caffe_escoin_tpu_torch.ops import deconv as deconv_ops
from caffe_escoin_tpu_torch.ops import linear as linear_ops
from caffe_escoin_tpu_torch.ops import losses as loss_ops
from caffe_escoin_tpu_torch.ops import norm as norm_ops
from caffe_escoin_tpu_torch.ops import pool as pool_ops
from caffe_escoin_tpu_torch.ops import recurrent as rec_ops
from caffe_escoin_tpu_torch.ops import s2d as s2d_ops
from caffe_escoin_tpu_torch.ops import structural as struct_ops
from caffe_escoin_tpu_torch.ops import wpack
from caffe_escoin_tpu_torch.sparse.weight_align import (AlignedConvWeight,
                                                        weight_align)


def _pair(v):
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return (v[0], v[0])
        return tuple(v)
    return (v, v)


def _ntuple(v, n):
    """Caffe's repeated-field rule: a scalar or a 1-list applies to every
    spatial dim, else one entry per dim."""
    if isinstance(v, (tuple, list)):
        t = tuple(v)
        if len(t) == 1:
            return t * n
        if len(t) != n:
            raise ValueError(f"expected {n} spatial values, got {t}")
        return t
    return (v,) * n


def _pack(p):
    """(r_in, r_out) W-pack factors of a conv or pool (set by
    nn/fuse.pack_narrow_chains); (1, 1) is unpacked execution."""
    return p.get("pack_in", 1), p.get("pack_out", 1)


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

    category = "data"

    def forward(self, params, inputs, state=None):
        return list(inputs)

    def out_shapes(self, in_shapes):
        return [tuple(s) for s in in_shapes]


@register_layer("Convolution")
class ConvolutionLayer(Layer):
    """Mode-dispatched 2-D conv. params keys: num_output, kernel, stride,
    pad, dilation, group, bias_term, weight_filler, bias_filler, fuse_relu,
    fuse_add (set by nn/fuse.py: a second bottom is the residual), and
    pack_in, pack_out, pack_w (set by nn/fuse.pack_narrow_chains: the conv
    reads and writes the W-pair packed layout of ops/wpack.py; pack_w is the
    logical input width), and s2d_r, s2d_kernel, s2d_pad (set by
    nn/fuse.fold_stem_s2d: the conv runs on ``ops/s2d.s2d_input`` of its
    input, and its kernel, stride and pad describe the remapped kernel).
    The params stay logical: a packed conv repacks its weight when it
    aligns it, or per call on the dense path. An input of another rank
    than 4, [N, *spatial, C] with 1 or 3 spatial dims, runs the dense N-D
    conv (``ops.conv.convnd_dense``; sparse execution is 2-D only, as in
    the reference)."""

    category = "conv"

    def _nd_conf(self, in_shape):
        """(kernel, stride, pad, dilation) of an N-D conv of this input."""
        n = len(in_shape) - 2
        return tuple(_ntuple(self.p.get(k, d), n) for k, d in (
            ("kernel", 3), ("stride", 1), ("pad", 0), ("dilation", 1)))

    def _in_shape(self, in_shape):
        """The shape of the input the conv runs on: the space-to-depth grid
        of a folded stem, else ``in_shape`` itself."""
        r = self.p.get("s2d_r")
        if not r:
            return tuple(in_shape)
        x = torch.empty(tuple(in_shape), device="meta")
        return tuple(s2d_ops.s2d_input(x, r, _pair(self.p["s2d_kernel"]),
                                       _pair(self.p["s2d_pad"])).shape)

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
                    bias=p.get("bias_term", True),
                    # logical channels of a packed input
                    cin=in_shape[-1] // p.get("pack_in", 1))

    def _geometry(self, in_shape):
        """(stride, padding, dilation) of the conv as it runs on an input of
        ``in_shape``: the spec's, or on the packed layout the packed W
        stride and padding of ``wpack.repack_geometry``."""
        c = self._conf(in_shape)
        r_in, r_out = _pack(self.p)
        if r_in == 1 and r_out == 1:
            return c["stride"], c["pad"], c["dilation"]
        (sh, sw), (ph, pw) = c["stride"], c["pad"]
        _, (pl, _), s_p, _, _ = wpack.repack_geometry(
            c["kernel"][1], r_in, r_out, sw, pw, in_shape[2] * r_in)
        return (sh, s_p), (ph, pl), (1, 1)

    def init_params(self, gen, in_shapes):
        if len(in_shapes[0]) != 4:
            kernel = self._nd_conf(in_shapes[0])[0]
            c = dict(kernel=kernel, cin=in_shapes[0][-1],
                     groups=self.p.get("group", 1),
                     cout=self.p["num_output"],
                     bias=self.p.get("bias_term", True))
        else:
            c = self._conf(self._in_shape(in_shapes[0]))
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
        if len(in_shapes[0]) != 4:
            conf = self._nd_conf(in_shapes[0])
            spatial = tuple(conv_ops._out_spatial(s, k, st, p, d)
                            for s, k, st, p, d in zip(in_shapes[0][1:-1],
                                                      *conf))
            return [(in_shapes[0][0], *spatial, self.p["num_output"])]
        in_shape = self._in_shape(in_shapes[0])
        c = self._conf(in_shape)
        r_in, r_out = _pack(self.p)
        n, h, w, _ = in_shape
        (kh, kw), (sh, sw) = c["kernel"], c["stride"]
        (ph, pw), (dh, dw) = c["pad"], c["dilation"]
        wo = conv_ops._out_spatial(w * r_in, kw, sw, pw, dw)
        return [(n, conv_ops._out_spatial(h, kh, sh, ph, dh), wo // r_out,
                 c["cout"] * r_out)]

    def align(self, params):
        """``weight_align`` under the layer's policy: the BSC, and the ELL
        of W^T where the policy's ``sparse_format`` is ELL. A packed conv
        aligns its packed weight (``wpack.repack_weight``, the bias tiled
        per output phase): the BSC is the packed weight's own zero
        structure."""
        if isinstance(params, AlignedConvWeight):
            return params
        if params["w"].ndim != 4:
            return params  # N-D: dense only, as in the reference
        r_in, r_out = _pack(self.p)
        if r_in == 1 and r_out == 1:
            return weight_align(params["w"], params.get("b"),
                                groups=self.p.get("group", 1),
                                policy=self.policy)
        wp, _, _ = wpack.repack_weight(
            torch.as_tensor(params["w"]).detach().cpu(), r_in, r_out,
            _pair(self.p.get("stride", 1))[1], _pair(self.p.get("pad", 0))[1],
            int(self.p["pack_w"]))
        b = params.get("b")
        if b is not None:
            b = torch.as_tensor(b).detach().cpu().repeat(r_out)
        return weight_align(wp, b, groups=1, policy=self.policy)

    def route(self, params, in_shapes, in_dtype):
        """``ops.conv.conv_route`` of this layer for an input of
        ``in_shapes[0]`` and ``in_dtype``, from shapes alone."""
        if not isinstance(params, AlignedConvWeight):
            return "dense"
        in_shape = self._in_shape(in_shapes[0])
        stride, pad, dil = self._geometry(in_shape)
        x = torch.empty(in_shape, dtype=self.policy.compute_dtype
                        or in_dtype, device="meta")
        return conv_ops.conv_route(x, params, stride=stride, padding=pad,
                                   dilation=dil, policy=self.policy)

    def forward(self, params, inputs, state=None):
        x = inputs[0]
        # the residual arrives in the output's layout, packed or not
        residual = (inputs[1] if len(inputs) > 1 and self.p.get("fuse_add")
                    else None)
        fuse_relu = self.p.get("fuse_relu", False) and self.policy.fuse_relu
        cd = self.policy.compute_dtype
        in_dtype = x.dtype
        if cd is not None:
            x = x.to(cd)
            params = _cast(params, cd)
            if residual is not None:
                residual = residual.to(cd)
        if x.dim() != 4:
            if residual is not None:
                raise ValueError("fuse_add is 2-D only")
            _, stride, pad, dil = self._nd_conf(x.shape)
            out = conv_ops.convnd_dense(
                x, params["w"], params.get("b"), stride=stride, padding=pad,
                dilation=dil, groups=self.p.get("group", 1), relu=fuse_relu)
            if cd is not None and self.policy.cast_back:
                out = out.to(in_dtype)
            return [out]
        if self.p.get("s2d_r"):
            x = s2d_ops.s2d_input(x, self.p["s2d_r"],
                                  _pair(self.p["s2d_kernel"]),
                                  _pair(self.p["s2d_pad"]))
        c = self._conf(x.shape)
        stride, pad, dil = self._geometry(x.shape)
        if isinstance(params, AlignedConvWeight):
            out = conv_ops.conv2d(x, params, stride=stride, padding=pad,
                                  dilation=dil, relu=fuse_relu,
                                  policy=self.policy, residual=residual)
        else:
            w, b = params["w"], params.get("b")
            r_in, r_out = _pack(self.p)
            if r_in > 1 or r_out > 1:
                w, _, _ = wpack.repack_weight(w, r_in, r_out, c["stride"][1],
                                              c["pad"][1], x.shape[2] * r_in)
                b = None if b is None else b.repeat(r_out)
            out = conv_ops.conv2d_dense(
                x, w, b, stride=stride, padding=pad, dilation=dil,
                groups=c["groups"], relu=fuse_relu, residual=residual)
        if cd is not None and self.policy.cast_back:
            out = out.to(in_dtype)
        return [out]


@register_layer("ConvolutionReLU")
class ConvolutionReLULayer(ConvolutionLayer):
    """Conv with ReLU fused into the kernel epilogue."""

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self.p["fuse_relu"] = True


@register_layer("EscConvolution")
class EscConvolutionLayer(ConvolutionLayer):
    """The reference's dense-baseline conv (``esc_conv_layer.cu`` pins
    cuDNN's IMPLICIT_GEMM; ``models/resnet/test_sconv.prototxt`` swaps it in
    per layer): LOWERED_GEMM whatever the net's policy."""

    def __init__(self, spec, policy):
        super().__init__(spec, dataclasses.replace(
            policy, conv_mode=ConvMode.LOWERED_GEMM))


# the kernel each ``Layer.route`` launches once per layer: the conv routes'
# kernels and the fc's SpMM ("dense" and the XBSP routes launch none)
ROUTE_KERNELS = {**conv_ops.ROUTE_KERNELS, "spmm": "bsc_spmm"}


@register_layer("InnerProduct")
class InnerProductLayer(Layer):
    """FC layer. Sparse execution runs a block-sparse SpMM over the 1x1
    GEMM-view AlignedConvWeight: the XBSP ``spmm`` with ``use_xla_sparse``,
    else the SpMM kernel."""

    category = "fc"

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
    """Max, average, stochastic and global pooling. ``pack_in``/``pack_out``
    (set by nn/fuse.pack_narrow_chains) make it pool between W-pair packed
    layouts (ops/wpack.py), so packed chains flow through it. Stochastic
    pooling samples in training from the generator ``Net.forward`` passes,
    and takes the weighted average otherwise."""

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self.uses_generator = self.p.get("mode") == "stochastic"

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
        r_in, r_out = _pack(self.p)
        a = self._args()
        wo = pool_ops._pooled_size(w * r_in, a["kernel"][1], a["stride"][1],
                                   a["padding"][1], a["ceil_mode"])
        return [(n, pool_ops._pooled_size(h, a["kernel"][0], a["stride"][0],
                                          a["padding"][0], a["ceil_mode"]),
                 wo // r_out, c // r_in * r_out)]

    def forward(self, params, inputs, state=None, *, train=False,
                generator=None):
        (x,) = inputs
        if self.p.get("global_pooling", False):
            return [pool_ops.pool2d(x, (1, 1), mode=self.p.get("mode", "avg"),
                                    global_pool=True, train=train,
                                    generator=generator)]
        if self.uses_generator:
            return [pool_ops.pool2d(x, **self._args(), train=train,
                                    generator=generator)]
        r_in, r_out = _pack(self.p)
        if r_in > 1 or r_out > 1:
            return [pool_ops.pool2d_packed(x, **self._args(), r_in=r_in,
                                           r_out=r_out)]
        return [pool_ops.pool2d(x, **self._args())]


@register_layer("ReLU")
class ReLULayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.relu(inputs[0], self.p.get("negative_slope", 0.0))]


@register_layer("Dropout")
class DropoutLayer(Layer):
    """The identity at inference; in training, inverted dropout with its
    mask drawn from the generator ``Net.forward`` passes."""

    uses_generator = True

    def forward(self, params, inputs, state=None, *, train=False,
                generator=None):
        return [act.dropout(inputs[0], self.p.get("ratio", 0.5),
                            generator=generator, train=train)]


@register_layer("Softmax")
class SoftmaxLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.softmax(inputs[0], self.p.get("axis", -1))]


@register_layer("BatchNorm")
class BatchNormLayer(Layer):
    """Caffe BatchNorm (batch_norm_layer.cpp). Its state holds the decayed
    sums ``mean_acc``/``var_acc`` and the normalisation ``count``, buffers
    the solver never updates (the reference pins them with lr_mult 0).

    ``use_global_stats`` None means "not in training". At global
    statistics the forward divides the sums by ``count`` (count 0 -> mean
    0, var 1). Otherwise it normalizes over every axis but the channel
    (the last) by the batch's mean and biased variance; in training it
    also returns the new state, ``acc = moving_average_fraction * acc +
    stat`` with the variance bias-corrected by m/(m-1) and ``count =
    fraction * count + 1`` (`batch_norm_layer.cpp:125-145`): a new dict of
    tensors outside the autograd graph, the old one left as it was."""

    has_state = True

    def init_state(self, in_shapes):
        c = in_shapes[0][-1]
        return {"mean_acc": torch.zeros(c), "var_acc": torch.zeros(c),
                "count": torch.zeros(())}

    def forward(self, params, inputs, state=None, *, train=False):
        (x,) = inputs
        eps = self.p.get("eps", 1e-5)
        use_global = self.p.get("use_global_stats")
        if use_global is None:
            use_global = not train
        if use_global:
            count = state["count"]
            inv_n = torch.where(count > 0, 1.0 / count.clamp_min(1e-30),
                                torch.zeros_like(count))
            mean = state["mean_acc"] * inv_n
            var = torch.where(count > 0, state["var_acc"] * inv_n,
                              torch.ones_like(state["var_acc"]))
            outs = [norm_ops.batch_norm_inference(x, mean, var, eps=eps)]
            return (outs, state) if train else outs
        axes = tuple(range(x.dim() - 1))
        out, bmean, bvar = norm_ops.batch_norm_train(x, axis=axes, eps=eps)
        if not train:
            return [out]
        lam = self.p.get("moving_average_fraction", 0.999)
        m = float(norm_ops.batch_count(x, axes))
        bias_corr = m / (m - 1.0) if m > 1 else 1.0
        with torch.no_grad():
            new_state = {
                "mean_acc": lam * state["mean_acc"] + bmean,
                "var_acc": lam * state["var_acc"] + bias_corr * bvar,
                "count": lam * state["count"] + 1.0,
            }
        return [out], new_state


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


@register_layer("LRN")
class LRNLayer(Layer):
    """Cross-channel LRN. On the W-pair packed layout (``pack_in``, set by
    nn/fuse.pack_narrow_chains) it normalizes each pixel phase's channel
    block on its own."""

    def forward(self, params, inputs, state=None):
        return [norm_ops.lrn_across_channels(
            inputs[0], local_size=self.p.get("local_size", 5),
            alpha=self.p.get("alpha", 1e-4), beta=self.p.get("beta", 0.75),
            k=self.p.get("k", 1.0), groups=self.p.get("pack_in", 1))]


@register_layer("Concat")
class ConcatLayer(Layer):
    """Joins its bottoms along ``axis`` (default -1: the NHWC channels)."""

    def _axis(self, ndim):
        return self.p.get("axis", -1) % ndim

    def out_shapes(self, in_shapes):
        ax = self._axis(len(in_shapes[0]))
        out = list(in_shapes[0])
        out[ax] = sum(s[ax] for s in in_shapes)
        return [tuple(out)]

    def forward(self, params, inputs, state=None):
        return [struct_ops.concat(inputs, axis=self._axis(inputs[0].dim()))]


@register_layer("Eltwise")
class EltwiseLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [struct_ops.eltwise(inputs, op=self.p.get("operation", "sum"),
                                   coeffs=self.p.get("coeffs"))]


class _MetaShapes:
    """``out_shapes`` by running the forward on meta tensors (the JAX
    package's ``jax.eval_shape``), for the shape-changing plumbing layers
    that hold no params."""

    def out_shapes(self, in_shapes):
        outs = self.forward({}, [torch.empty(tuple(s), device="meta")
                                 for s in in_shapes])
        return [tuple(o.shape) for o in outs]


@register_layer("PReLU")
class PReLULayer(Layer):
    def init_params(self, gen, in_shapes):
        n = 1 if self.p.get("channel_shared", False) else in_shapes[0][-1]
        return {"alpha": torch.full((n,), float(self.p.get("alpha_init",
                                                            0.25)))}

    def forward(self, params, inputs, state=None):
        return [act.prelu(inputs[0], params["alpha"])]


@register_layer("ELU")
class ELULayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.elu(inputs[0], self.p.get("alpha", 1.0))]


@register_layer("Sigmoid")
class SigmoidLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.sigmoid(inputs[0])]


@register_layer("TanH")
class TanHLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.tanh(inputs[0])]


@register_layer("BNLL")
class BNLLLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.bnll(inputs[0])]


@register_layer("AbsVal")
class AbsValLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.absval(inputs[0])]


@register_layer("Power")
class PowerLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.power(inputs[0], self.p.get("power", 1.0),
                          self.p.get("scale", 1.0), self.p.get("shift", 0.0))]


@register_layer("Exp")
class ExpLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.exp(inputs[0], self.p.get("base", -1.0),
                        self.p.get("scale", 1.0), self.p.get("shift", 0.0))]


@register_layer("Log")
class LogLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.log(inputs[0], self.p.get("base", -1.0),
                        self.p.get("scale", 1.0), self.p.get("shift", 0.0))]


@register_layer("Threshold")
class ThresholdLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [act.threshold(inputs[0], self.p.get("threshold", 0.0))]


class _LossLayer(Layer):
    """A loss: one scalar top. A spec without a loss weight gets 1.0, as
    Caffe's loss layers (and the JAX layers, which set it on the spec)."""

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        if spec.loss_weight == 0.0:
            object.__setattr__(spec, "loss_weight", 1.0)

    def out_shapes(self, in_shapes):
        return [()]


@register_layer("SoftmaxWithLoss")
class SoftmaxWithLossLayer(_LossLayer):
    """The mean cross-entropy of logits and integer labels."""

    def forward(self, params, inputs, state=None):
        logits, labels = inputs
        return [loss_ops.softmax_cross_entropy(
            logits, labels, ignore_label=self.p.get("ignore_label"))]


@register_layer("SigmoidCrossEntropyLoss")
class SigmoidCELossLayer(_LossLayer):
    def forward(self, params, inputs, state=None):
        return [loss_ops.sigmoid_cross_entropy(inputs[0], inputs[1])]


@register_layer("EuclideanLoss")
class EuclideanLossLayer(_LossLayer):
    def forward(self, params, inputs, state=None):
        return [loss_ops.euclidean_loss(inputs[0], inputs[1])]


@register_layer("HingeLoss")
class HingeLossLayer(_LossLayer):
    def forward(self, params, inputs, state=None):
        return [loss_ops.hinge_loss(inputs[0], inputs[1],
                                    norm=self.p.get("norm", "L1"))]


@register_layer("ContrastiveLoss")
class ContrastiveLossLayer(_LossLayer):
    def forward(self, params, inputs, state=None):
        return [loss_ops.contrastive_loss(
            inputs[0], inputs[1], inputs[2],
            margin=self.p.get("margin", 1.0),
            legacy_version=self.p.get("legacy_version", False))]


@register_layer("MultinomialLogisticLoss")
class MultinomialLogisticLossLayer(_LossLayer):
    def forward(self, params, inputs, state=None):
        return [loss_ops.multinomial_logistic_loss(inputs[0], inputs[1])]


@register_layer("InfogainLoss")
class InfogainLossLayer(_LossLayer):
    """H from the ``infogain`` param, else the identity (the multinomial
    logistic loss)."""

    def forward(self, params, inputs, state=None):
        probs = inputs[0]
        h = self.p.get("infogain")
        if h is None:
            h = torch.eye(probs.shape[-1], dtype=probs.dtype,
                          device=probs.device)
        return [loss_ops.infogain_loss(probs, inputs[1], torch.as_tensor(
            h, dtype=probs.dtype, device=probs.device))]


@register_layer("Accuracy")
class AccuracyLayer(_MetaShapes, Layer):
    def forward(self, params, inputs, state=None):
        return [loss_ops.accuracy(inputs[0], inputs[1],
                                  top_k=self.p.get("top_k", 1),
                                  ignore_label=self.p.get("ignore_label"))]


@register_layer("Bias")
class BiasLayer(Layer):
    """Adds a bias along an axis span (bias_layer.cpp): a second bottom, or
    a param of shape bottom.shape[axis:axis+num_axes]. ``axis`` counts in
    Caffe's (N, C, H, W) order on a 4-d blob, so the default axis 1 is the
    NHWC channel; a blob of another rank is indexed as it is."""

    def _canon_axes(self, ndim):
        axis, num_axes = self.p.get("axis", 1), self.p.get("num_axes", 1)
        if ndim == 4:
            order = [0, 3, 1, 2]  # canonical i lives at NHWC dim order[i]
            return sorted(order[axis + k] for k in range(num_axes))
        return list(range(axis, axis + num_axes))

    def init_params(self, gen, in_shapes):
        if len(in_shapes) > 1:
            return {}
        shape = tuple(in_shapes[0][d]
                      for d in self._canon_axes(len(in_shapes[0])))
        return {"b": fill(gen, shape,
                          self.p.get("filler", {"type": "constant"}))}

    def forward(self, params, inputs, state=None):
        x = inputs[0]
        b = inputs[1] if len(inputs) > 1 else params["b"]
        shape = [1] * x.dim()
        for d, n in zip(self._canon_axes(x.dim()), b.shape):
            shape[d] = n
        return [x + b.reshape(shape)]


@register_layer("MVN")
class MVNLayer(Layer):
    def forward(self, params, inputs, state=None):
        return [norm_ops.mvn(inputs[0], normalize_variance=self.p.get(
            "normalize_variance", True))]


@register_layer("Flatten")
class FlattenLayer(_MetaShapes, Layer):
    def forward(self, params, inputs, state=None):
        return [struct_ops.flatten(inputs[0], self.p.get("axis", 1))]


@register_layer("Reshape")
class ReshapeLayer(_MetaShapes, Layer):
    def forward(self, params, inputs, state=None):
        return [struct_ops.reshape(inputs[0], self.p["shape"])]


@register_layer("Slice")
class SliceLayer(_MetaShapes, Layer):
    def forward(self, params, inputs, state=None):
        return list(struct_ops.slice_points(
            inputs[0], self.p["slice_points"], axis=self.p.get("axis", -1)))


@register_layer("Split")
class SplitLayer(_MetaShapes, Layer):
    def forward(self, params, inputs, state=None):
        return list(struct_ops.split(inputs[0], len(self.spec.tops)))


@register_layer("Crop")
class CropLayer(_MetaShapes, Layer):
    def forward(self, params, inputs, state=None):
        x, ref = inputs
        return [struct_ops.crop(x, ref.shape,
                                offsets=self.p.get("offsets", (0, 0)),
                                axes=self.p.get("axes", (1, 2)))]


@register_layer("Tile")
class TileLayer(_MetaShapes, Layer):
    def forward(self, params, inputs, state=None):
        return [struct_ops.tile(inputs[0], self.p["tiles"],
                                self.p.get("axis", -1))]


@register_layer("Reduction")
class ReductionLayer(_MetaShapes, Layer):
    def forward(self, params, inputs, state=None):
        return [struct_ops.reduction(inputs[0],
                                     op=self.p.get("operation", "sum"),
                                     axis=self.p.get("axis"),
                                     coeff=self.p.get("coeff", 1.0))]


@register_layer("ArgMax")
class ArgMaxLayer(_MetaShapes, Layer):
    def forward(self, params, inputs, state=None):
        return [struct_ops.argmax(inputs[0], self.p.get("axis", -1))]


@register_layer("Silence")
class SilenceLayer(Layer):
    """Consumes its bottoms and has no tops (silence_layer.cpp), so they
    leave the net's final tops."""

    def forward(self, params, inputs, state=None):
        return []

    def out_shapes(self, in_shapes):
        return []


@register_layer("DummyData")
class DummyDataLayer(Layer):
    """A constant blob (dummy_data_layer.cpp). It has no bottom to take a
    device from, so it is made on the CPU: a net on the card that reads it
    fails on the device mismatch instead of moving data behind a caller's
    back."""

    category = "data"

    def forward(self, params, inputs, state=None):
        return [torch.full(tuple(self.p["shape"]),
                           float(self.p.get("value", 0.0)))]

    def out_shapes(self, in_shapes):
        return [tuple(self.p["shape"])]


@register_layer("Deconvolution")
class DeconvolutionLayer(Layer):
    """Transposed conv (deconv_layer.cpp), ``ops.deconv.deconv2d``. The
    weight is [KH, KW, Cin, Cout] (the `.caffemodel` blob [Cin, Cout, KH,
    KW], tools/caffemodel.py). The JAX layer ignores ``group``; this one
    raises on a group other than 1 rather than compute another function."""

    category = "conv"

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        if self.p.get("group", 1) != 1:
            raise ValueError(f"{spec.name}: Deconvolution with group "
                             f"{self.p['group']} is not supported")

    def _geometry(self):
        p = self.p
        return (_pair(p.get("kernel", 3)), _pair(p.get("stride", 1)),
                _pair(p.get("pad", 0)), _pair(p.get("dilation", 1)))

    def init_params(self, gen, in_shapes):
        (kh, kw), _, _, _ = self._geometry()
        cin = in_shapes[0][-1]
        params = {"w": fill(gen, (kh, kw, cin, self.p["num_output"]),
                            self.p.get("weight_filler", {"type": "xavier"}),
                            fan_in=kh * kw * cin)}
        if self.p.get("bias_term", True):
            params["b"] = fill(gen, (self.p["num_output"],),
                               self.p.get("bias_filler", {"type": "constant"}))
        return params

    def out_shapes(self, in_shapes):
        n, h, w, _ = in_shapes[0]
        kernel, stride, pad, dil = self._geometry()
        ho, wo = ((s - 1) * st + d * (k - 1) + 1 - 2 * p for s, k, st, p, d
                  in zip((h, w), kernel, stride, pad, dil))
        return [(n, ho, wo, self.p["num_output"])]

    def forward(self, params, inputs, state=None):
        _, stride, pad, dil = self._geometry()
        return [deconv_ops.deconv2d(inputs[0], params["w"], params.get("b"),
                                    stride=stride, padding=pad,
                                    dilation=dil)]


@register_layer("SPP")
class SPPLayer(_MetaShapes, Layer):
    """Spatial pyramid pooling (spp_layer.cpp), ``ops.pool.spp``."""

    def forward(self, params, inputs, state=None):
        return [pool_ops.spp(inputs[0], self.p.get("pyramid_height", 3),
                             mode=self.p.get("mode", "max"))]


@register_layer("Im2col")
class Im2colLayer(_MetaShapes, Layer):
    """The lowering as a layer (im2col_layer.cpp): [N, Ho, Wo, KH*KW*C] in
    (kh, kw, c) column order, ``ops.conv.im2col``."""

    def forward(self, params, inputs, state=None):
        p = self.p
        cols, _ = conv_ops.im2col(inputs[0], _pair(p.get("kernel", 3)),
                                  stride=_pair(p.get("stride", 1)),
                                  padding=_pair(p.get("pad", 0)),
                                  dilation=_pair(p.get("dilation", 1)))
        return [cols]


class _RecurrentLayer(Layer):
    """Shared by RNN and LSTM: bottoms x [T, N, D] and cont [T, N]; params
    wx [D, G*H], wh [H, G*H], b [G*H] with G gates."""

    gates = 1

    def init_params(self, gen, in_shapes):
        d, h = in_shapes[0][-1], self.p["num_output"]
        g = self.gates * h
        wf = self.p.get("weight_filler", {"type": "xavier"})
        return {"wx": fill(gen, (d, g), wf, fan_in=d),
                "wh": fill(gen, (h, g), wf, fan_in=h),
                "b": fill(gen, (g,), self.p.get("bias_filler",
                                                {"type": "constant"}))}

    def out_shapes(self, in_shapes):
        t, n, _ = in_shapes[0]
        return [(t, n, self.p["num_output"])]


@register_layer("RNN")
class RNNLayer(_RecurrentLayer):
    """Caffe's RNN (rnn_layer.cpp), ``ops.recurrent.rnn_forward``."""

    def forward(self, params, inputs, state=None):
        x, cont = inputs
        return [rec_ops.rnn_forward(x, cont, params["wx"], params["wh"],
                                    params["b"])]


@register_layer("LSTM")
class LSTMLayer(_RecurrentLayer):
    """Caffe's LSTM (lstm_layer.cpp), gate order i, f, o, g; the top is the
    hidden sequence."""

    gates = 4

    def forward(self, params, inputs, state=None):
        x, cont = inputs
        hs, _ = rec_ops.lstm_forward(x, cont, params["wx"], params["wh"],
                                     params["b"])
        return [hs]


@register_layer("LSTMUnit")
class LSTMUnitLayer(Layer):
    """One LSTM cell step (lstm_unit_layer.cpp): bottoms c_prev [N, H],
    gate pre-activations [N, 4H] (order i, f, o, g) and cont [N]; tops
    (c, h). cont 0 resets the cell."""

    def forward(self, params, inputs, state=None):
        c_prev, gates, cont = inputs
        c_prev = c_prev * cont.reshape(-1, 1).to(gates.dtype)
        return list(rec_ops.lstm_step(c_prev, gates))

    def out_shapes(self, in_shapes):
        n, four_h = in_shapes[1]
        return [(n, four_h // 4), (n, four_h // 4)]


@register_layer("Embed")
class EmbedLayer(Layer):
    """Embedding lookup (embed_layer.cpp): integer-valued indices ->
    rows of w [input_dim, num_output]."""

    def init_params(self, gen, in_shapes):
        return {"w": fill(gen, (self.p["input_dim"], self.p["num_output"]),
                          self.p.get("weight_filler", {"type": "xavier"}),
                          fan_in=self.p["input_dim"])}

    def out_shapes(self, in_shapes):
        return [tuple(in_shapes[0]) + (self.p["num_output"],)]

    def forward(self, params, inputs, state=None):
        return [params["w"][inputs[0].long()]]


@register_layer("BatchReindex")
class BatchReindexLayer(Layer):
    """Gathers batch items by an index blob (batch_reindex_layer.cpp)."""

    def out_shapes(self, in_shapes):
        return [tuple(in_shapes[1][:1]) + tuple(in_shapes[0][1:])]

    def forward(self, params, inputs, state=None):
        x, idx = inputs
        return [x[idx.long()]]


@register_layer("Filter")
class FilterLayer(Layer):
    """Keeps the batch items whose selector (the last bottom) is nonzero
    (filter_layer.cpp): one top per other bottom, holding only the kept
    items, then the selector mask (1.0 kept, 0.0 dropped) over the whole
    batch. The JAX layer cannot change a shape under jit, so it returns
    the batch with the dropped items zeroed; here the output is Caffe's,
    whose batch size depends on the data: ``out_shapes`` gives the input's
    (an upper bound), and a net with Filter runs eagerly."""

    graph_safe = False

    def out_shapes(self, in_shapes):
        return [tuple(s) for s in in_shapes[:-1]] + [tuple(in_shapes[-1][:1])]

    def forward(self, params, inputs, state=None):
        *xs, selector = inputs
        keep = selector.reshape(selector.shape[0], -1)[:, 0] != 0
        return [x[keep] for x in xs] + [keep.to(xs[0].dtype)]


@register_layer("Parameter")
class ParameterLayer(Layer):
    """Emits a learnable blob of ``shape`` (parameter_layer.cpp)."""

    def init_params(self, gen, in_shapes):
        return {"w": fill(gen, tuple(self.p["shape"]),
                          self.p.get("filler", {"type": "constant"}))}

    def out_shapes(self, in_shapes):
        return [tuple(self.p["shape"])]

    def forward(self, params, inputs, state=None):
        return [params["w"]]


@register_layer("Python")
class PythonLayer(Layer):
    """A user's layer class, resolved when the Net is built: the reference's
    PythonLayer (`include/caffe/layers/python_layer.hpp`, prototxt
    ``python_param {module, layer, param_str}``). The class
    ``<module>.<layer>`` must subclass ``caffe_escoin_tpu_torch.nn.Layer``;
    its instance takes this layer's place (``__new__`` returns it), so its
    own init_params, forward and out_shapes run. ``param_str`` reaches it
    as ``spec.params["param_str"]``."""

    def __new__(cls, spec, policy):
        import importlib

        module = spec.params.get("module")
        lname = spec.params.get("layer")
        if not module or not lname:
            raise ValueError(
                f"Python layer {spec.name!r} needs python_param "
                f"module/layer (got module={module!r}, layer={lname!r})")
        target = getattr(importlib.import_module(module), lname)
        if not (isinstance(target, type) and issubclass(target, Layer)):
            raise TypeError(f"{module}.{lname} must subclass "
                            f"caffe_escoin_tpu_torch.nn.Layer")
        return target(spec, policy)
