"""The dense conv's epilogue (``kernels/conv_epilogue.py``) on the CPU.

``ops/conv.conv2d_dense`` hands a conv's bias, residual and ReLU to the
wrapper, which on a CPU tensor runs the plain version and launches nothing:
the conv adds the bias there, as it did, and the rest is the former
residual add and ReLU, bit for bit. The plain version is held to the kernel's
arithmetic written out in numpy (each sum in f32, rounded once to the map's
type), so the kernel can be held to it on the card (tests/test_torch_cuda.py).
The launch that the CUDA kernel reads takes the 16-byte vector exactly where
C, the pointers and the strides allow it, and its grid covers the map, one
thread a vector; at every dense conv of the benchmark's three
configurations at batch 8 and 32 it takes the vector. ``Net.launches`` declares one
launch a dense conv with a bias, a ReLU or a residual that the stem kernel
does not take (ResNet-50's 1 of 2, GoogLeNet's 9 of 10), none for one with
none of them, and the trace lists the kernel beside the LRN's and the max
pool's.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu_torch.kernels import conv_epilogue
from caffe_escoin_tpu_torch.models import ZOO
from caffe_escoin_tpu_torch.nn import LayerSpec, Net, fuse_inference
from caffe_escoin_tpu_torch.ops import conv as conv_ops
from caffe_escoin_tpu_torch.utils import trace
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

BLOCK = (128, 128)
# the dense convs of the benchmark's configurations (every conv with Cin of
# 32 or more pruned to 90% of its 128x128 blocks, at least one kept): the
# stems, and convs of fewer than 32 input channels or of one block
DENSE_CONVS = {
    "resnet50": ("conv1", "res2a_branch2a"),
    "googlenet": ("conv1/7x7_s2", "conv2/3x3_reduce", "inception_3a/1x1",
                  "inception_3a/3x3_reduce", "inception_3a/5x5_reduce",
                  "inception_3a/5x5", "inception_3a/pool_proj",
                  "inception_4a/5x5", "inception_4b/5x5", "inception_4c/5x5"),
    # the stem and the autotuner's dense picks in vgg16-b32-offline-autotuned
    "vgg16": ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_2",
              "conv3_3"),
}
CHANNELS = (3, 16, 64, 96, 1000)


def _t(shape, seed, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(dtype)


def _round(a: np.ndarray, dtype) -> np.ndarray:
    """f32 values rounded to ``dtype`` (to nearest even), back in f32."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def _kernel_arithmetic(y, bias, relu, residual):
    """What csrc/conv_epilogue.cu computes, written out: each sum in f32,
    rounded once to the map's type; ReLU keeps a NaN."""
    a = y.float().numpy()
    if bias is not None:
        a = _round(a + bias.float().numpy(), y.dtype)
    if residual is not None:
        a = _round(a + residual.to(y.dtype).float().numpy(), y.dtype)
    if relu:
        a = np.where(np.isnan(a), a, np.maximum(a, np.float32(0)))
    return torch.from_numpy(a).to(y.dtype)


def _former_epilogue(out, relu, residual=None):
    """What ``conv2d_dense`` ran after ``F.conv2d`` before the epilogue
    kernel: the residual added in out's dtype, ``torch.relu``, a copy to
    contiguous."""
    if residual is not None:
        out = out + residual.to(out.dtype)
    if relu:
        out = torch.relu(out)
    return out.contiguous()


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(a.contiguous().view(view), b.contiguous().view(view))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_kernels_arithmetic(dtype, c, relu, residual):
    """The plain version (PyTorch's passes after cuDNN) equals the kernel's
    arithmetic bit for bit, and the sequence ATen ran on the card: the
    bias added in place over the channels_last NCHW output, then the former
    residual add and ReLU."""
    y = _t((2, 3, 5, c), 1, dtype, 4.0)
    y[0, 0, 0, :min(c, 4)] = torch.tensor([0.0, -0.0, float("nan"),
                                           float("inf")][:min(c, 4)])
    b = _t((c,), 2, dtype)
    r = _t((2, 3, 5, c), 3, dtype, 2.0) if residual else None
    got = conv_epilogue.epilogue_plain(y, b, relu=relu, residual=r)
    assert got.is_contiguous()
    want = _kernel_arithmetic(y, b, relu, r)
    assert torch.equal(got.isnan(), want.isnan())
    _same_bits(torch.nan_to_num(got), torch.nan_to_num(want))
    nchw = y.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    aten = _former_epilogue(nchw.add_(b.reshape(1, c, 1, 1)).permute(
        0, 2, 3, 1), relu, r)
    _same_bits(torch.nan_to_num(got), torch.nan_to_num(aten))


@pytest.mark.parametrize("bias, relu, residual", [
    (True, False, False), (True, True, False), (True, True, True),
    (False, True, False), (False, False, True), (False, False, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_conv2d_dense_is_the_former_code(dtype, bias, relu, residual):
    """On the CPU ``conv2d_dense`` is the code it was (``F.conv2d`` with
    the bias, then the residual and ReLU), bit for bit; one entry call
    where there is a bias, a ReLU or a residual, and no launch."""
    x = _t((2, 7, 6, 16), 4, dtype)
    w = _t((3, 3, 16, 24), 5, torch.float32, 0.2)
    b = _t((24,), 6, torch.float32) if bias else None
    r = _t((2, 7, 6, 24), 7, dtype) if residual else None
    calls, launches = conv_epilogue.calls, conv_epilogue.launches
    got = conv_ops.conv2d_dense(x, w, b, padding=(1, 1), relu=relu,
                                residual=r)
    assert conv_epilogue.calls == calls + int(bias or relu or residual)
    assert conv_epilogue.launches == launches
    out = F.conv2d(x.permute(0, 3, 1, 2), w.to(dtype).permute(3, 2, 0, 1),
                   None if b is None else b.to(dtype), padding=(1, 1))
    want = _former_epilogue(out.permute(0, 2, 3, 1), relu, r)
    assert got.is_contiguous()
    _same_bits(got, want)


def test_cpu_conv2d_dense_keeps_its_gradient():
    """A training forward (grad needed) runs the plain version, and its
    gradients are those of the former code."""
    x = _t((1, 5, 5, 8), 8, torch.float32).requires_grad_()
    w = _t((3, 3, 8, 8), 9, torch.float32, 0.3).requires_grad_()
    b = _t((8,), 10, torch.float32).requires_grad_()
    assert not conv_epilogue.takes_kernel(x, w, b)
    conv_ops.conv2d_dense(x, w, b, padding=(1, 1), relu=True).sum().backward()
    got = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                   padding=(1, 1))
    torch.relu(out).sum().backward()
    for g, t in zip(got, (x, w, b)):
        assert torch.equal(g, t.grad)


def test_takes_kernel_only_on_cuda():
    x = torch.zeros(1, 2, 2, 8)
    assert not conv_epilogue.takes_kernel(x)
    assert not conv_epilogue.takes_kernel(x.to("meta"), None)
    meta = conv_ops.conv2d_dense(x.to("meta"), torch.zeros(1, 1, 8, 4,
                                                           device="meta"),
                                 torch.zeros(4, device="meta"), relu=True)
    assert meta.shape == (1, 2, 2, 4) and meta.device.type == "meta"


def test_kernel_refuses_what_it_does_not_take():
    """The wrapper's checks, which run before anything touches a card."""
    y = torch.zeros(1, 2, 2, 8, dtype=torch.float16)
    with pytest.raises(TypeError):
        conv_epilogue._kernel(y, None, True, None)
    y = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError):
        conv_epilogue._kernel(y, torch.zeros(4), False, None)
    with pytest.raises(ValueError):
        conv_epilogue._kernel(y, None, False, torch.zeros(1, 2, 2, 4))
    with pytest.raises(ValueError):
        conv_epilogue._kernel(y[0], None, True, None)
    with pytest.raises(TypeError):
        conv_epilogue.launch_args((1, 2, 2, 8), torch.float16, None, True,
                                  True)
    with pytest.raises(ValueError):
        conv_epilogue.launch_args((1, 0, 2, 8), torch.float32, None, True,
                                  True)
    with pytest.raises(ValueError):
        conv_epilogue.launch_args((2 ** 16, 2 ** 8, 2 ** 8, 1),
                                  torch.float32, None, True, True)


def test_kernel_counts_and_snapshot_list_conv_epilogue():
    assert ("conv_epilogue" in trace.OP_KERNELS
            and "conv_epilogue" not in trace.KERNELS)
    counts = trace.kernel_counts()
    assert set(counts) == set(trace.KERNELS + trace.OP_KERNELS)
    assert counts["conv_epilogue"] == {
        "calls": conv_epilogue.calls, "launches": conv_epilogue.launches,
        "launches_f32": conv_epilogue.launches_f32}
    assert (trace.snapshot()["kernels"]["conv_epilogue"]
            == counts["conv_epilogue"])


def _covers(la, shape):
    """One thread a vector: the fewest blocks whose threads cover the
    map's vectors."""
    n, h, w, c = shape
    vectors = n * h * w * c // la.lanes
    return (la.blocks * la.threads >= vectors
            and (la.blocks - 1) * la.threads < vectors)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", CHANNELS + (8, 12, 24, 48))
def test_launch_args_vector_exactly_where_it_fits(dtype, c):
    """The vector where its lanes divide C and every pointer is aligned
    (and, reading through strides, the channels are adjacent and each
    stride a multiple of it); the arguments in the kernel's order; a grid
    that covers the map, one thread a vector."""
    wide = 16 // (torch.finfo(dtype).bits // 8)
    shape = (2, 3, 5, c)
    for aligned in (True, False):
        la = conv_epilogue.launch_args(shape, dtype, None, aligned, True)
        fits = c % wide == 0 and aligned
        assert la.lanes == (wide if fits else 1)
        assert not la.strided
        assert list(la.dims) == [*shape, 3 * 5 * c, 5 * c, c, 1, la.lanes,
                                 la.threads, la.blocks, 1, 0]
        assert la.threads % 32 == 0 and la.threads <= 256
        assert _covers(la, shape)
    # an NCHW-contiguous output read through its strides: channels apart
    strided = (3 * 5 * c, 5, 1, 3 * 5)
    la = conv_epilogue.launch_args(shape, dtype, strided, True, False)
    assert la.strided and la.lanes == 1
    assert list(la.dims) == [*shape, *strided, 1, la.threads, la.blocks, 0,
                             1]
    assert _covers(la, shape)
    # channels adjacent, pixels padded to a multiple of the vector
    padded = (3 * 5 * 2 * c, 5 * 2 * c, 2 * c, 1)
    la = conv_epilogue.launch_args(shape, dtype, padded, True, False)
    assert la.strided and la.lanes == (wide if c % wide == 0 else 1)
    assert _covers(la, shape)


def _dense_conv_outputs(model, batch):
    """(name, output shape) of each of ``DENSE_CONVS[model]``."""
    build, shapes = ZOO[model]
    net = Net(build())
    out = {}
    for layer, in_shapes in net.walk_shapes(
            {"data": (batch,) + tuple(shapes["data"][1:])}):
        if layer.spec.name in DENSE_CONVS[model]:
            out[layer.spec.name] = tuple(layer.out_shapes(in_shapes)[0])
    assert set(out) == set(DENSE_CONVS[model])
    return out


@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("model", list(DENSE_CONVS))
def test_launch_args_at_the_configurations_dense_convs(model, batch):
    """Every dense conv of the three configurations takes the 16-byte
    vector over a grid that covers it."""
    for name, shape in _dense_conv_outputs(model, batch).items():
        la = conv_epilogue.launch_args(shape, torch.bfloat16, None, True,
                                       True)
        assert shape[3] in (16, 32, 48, 64, 96, 128, 192, 256), name
        assert la.lanes == 8, name
        assert _covers(la, shape), name


def _pruned(net, params):
    out = dict(params)
    for layer in net.layers:
        name = layer.spec.name
        if name not in out or layer.spec.type not in ("Convolution",
                                                      "ConvolutionReLU"):
            continue
        w = out[name]["w"].numpy()
        if w.shape[2] >= 32:
            out[name] = {**out[name], "w": torch.from_numpy(
                prune_conv_weight(w, 0.9, BLOCK))}
    return out


@pytest.mark.parametrize("model, n", [("resnet50", 2), ("googlenet", 10)])
def test_net_launches_one_epilogue_a_dense_conv(model, n):
    """ResNet-50's and GoogLeNet's configurations (b8, bf16, fused, on the
    kernel routes): the dense routes are ``DENSE_CONVS``, the stem
    declaring one ``stem_conv`` launch and each other one epilogue
    launch."""
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                          compute_dtype=torch.bfloat16, cast_back=False,
                          use_xla_sparse=False)
    build, shapes = ZOO[model]
    shapes = {"data": (8,) + tuple(shapes["data"][1:])}
    net = Net(build(), policy=pol)
    params = net.init(torch.Generator().manual_seed(0), shapes)
    fnet, fparams = fuse_inference(net, _pruned(net, params),
                                   state=net.state0)
    aligned = fnet.weight_align(fparams)
    routes = fnet.routes(aligned, shapes, torch.bfloat16)
    convs = {l.spec.name for l in fnet.layers if l.category == "conv"}
    assert sorted(k for k, r in routes.items()
                  if r == "dense" and k in convs) == sorted(DENSE_CONVS[model])
    declared = fnet.launches(aligned, shapes, torch.bfloat16)
    assert (declared["conv_epilogue"], declared["stem_conv"]) == (n - 1, 1)


@pytest.mark.parametrize("bias, relu, want", [
    (False, False, 0), (True, False, 1), (False, True, 1), (True, True, 1)])
def test_a_conv_declares_an_epilogue_only_with_work(bias, relu, want):
    """A dense conv with no bias and no ReLU declares and calls none; with
    either, one. An N-D conv (``convnd_dense``) declares none."""
    kind = "ConvolutionReLU" if relu else "Convolution"
    net = Net([LayerSpec("conv", kind, ("data",), ("c",),
                         params=dict(num_output=8, kernel=3, pad=1,
                                     bias_term=bias))])
    shapes = {"data": (1, 6, 6, 4)}
    params = net.init(torch.Generator().manual_seed(0), shapes)
    assert net.launches(params, shapes)["conv_epilogue"] == want
    calls = conv_epilogue.calls
    net.apply(params, {"data": _t(shapes["data"], 11, torch.float32)})
    assert conv_epilogue.calls == calls + want
    nd = Net([LayerSpec("conv3d", kind, ("data",), ("c",),
                        params=dict(num_output=4, kernel=3, bias_term=bias))])
    shapes = {"data": (1, 4, 4, 4, 2)}
    params = nd.init(torch.Generator().manual_seed(0), shapes)
    assert nd.launches(params, shapes)["conv_epilogue"] == 0
