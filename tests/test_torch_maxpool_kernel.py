"""The max-pool kernel's wrapper (``kernels/maxpool.py``) on the CPU.

``ops/pool.pool2d``'s max branch calls the wrapper, which on a CPU tensor
runs the plain version and launches nothing (its values are held to the
JAX package's in tests/test_torch_ops.py). The launch that the CUDA kernel
reads covers the output with a grid that is not oversized, takes a vector
whose lanes divide C, and gives every SM a block at every max pool of the
benchmark's three configurations at batch 8 and 32. The
``torch.autograd.Function`` around the launch gives the plain version's
gradient (checked with the launch replaced by the plain forward, since the
kernel runs only on the card; its own parity is in
tests/test_torch_cuda.py), and the trace lists the kernel beside the LRN's.
"""

import numpy as np
import pytest
import torch

from caffe_escoin_tpu_torch.kernels import maxpool
from caffe_escoin_tpu_torch.models import ZOO
from caffe_escoin_tpu_torch.nn import LayerSpec, Net
from caffe_escoin_tpu_torch.ops import pool as pool_ops
from caffe_escoin_tpu_torch.utils import trace

H100_SMS = 132
# the benchmark's configurations -> their max pools (13, 1 and 5)
CONFIG_MODELS = {"googlenet": 13, "resnet50": 1, "vgg16": 5}


def _max_pools(model, batch):
    """(name, input shape, kernel, stride, padding) of every max pool of
    ``model`` at ``batch``, in order."""
    build, shapes = ZOO[model]
    net = Net(build())
    out = []
    for layer, in_shapes in net.walk_shapes({"data": (batch,)
                                             + shapes["data"][1:]}):
        if (layer.spec.type == "Pooling"
                and layer.p.get("mode", "max") == "max"
                and not layer.p.get("global_pooling", False)):
            a = layer._args()
            out.append((layer.spec.name, in_shapes[0], a["kernel"],
                        a["stride"], a["padding"]))
    return out


def _out_size(shape, kernel, stride, padding):
    return tuple(pool_ops._pooled_size(n, k, s, p, True)
                 for n, k, s, p in zip(shape[1:3], kernel, stride, padding))


def _x(shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def test_pool_layer_spp_and_packed_out_go_through_the_wrapper():
    """One wrapper call a max pool, and on the CPU no launch."""
    net = Net([LayerSpec("pool", "Pooling", ("data",), ("p",),
                         params=dict(kernel=3, stride=2))])
    x = _x((1, 9, 9, 16), seed=2, dtype=torch.bfloat16)
    calls, launches = maxpool.calls, maxpool.launches
    out = net.apply({}, {"data": x})["p"]
    assert maxpool.calls == calls + 1
    assert torch.equal(out, maxpool.max_pool_plain(x, (3, 3), (2, 2), (0, 0),
                                                   (4, 4)))
    pool_ops.spp(x, 3)
    assert maxpool.calls == calls + 4  # one pool2d a pyramid level
    pool_ops.pool2d_packed_out(x[:, :8, :8], (2, 2), stride=(2, 2))
    assert maxpool.calls == calls + 5
    assert maxpool.launches == launches


def test_kernel_counts_and_snapshot_list_maxpool():
    assert "maxpool" in trace.OP_KERNELS and "maxpool" not in trace.KERNELS
    counts = trace.kernel_counts()
    assert set(counts) == set(trace.KERNELS + trace.OP_KERNELS)
    assert counts["maxpool"] == {"calls": maxpool.calls,
                                 "launches": maxpool.launches,
                                 "launches_f32": maxpool.launches_f32}
    assert trace.snapshot()["kernels"]["maxpool"] == counts["maxpool"]


def test_the_configurations_have_their_max_pools():
    """GoogLeNet's four stem and stage pools and nine inception pools,
    ResNet-50's pool1, VGG-16's five."""
    for model, n in CONFIG_MODELS.items():
        assert len(_max_pools(model, 8)) == n


def _threads(la):
    n, h, w, c = la.dims[:4]
    return n * -(-la.out_shape[1] // la.rows) * la.out_shape[2] * (
        c // la.lanes)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("model", list(CONFIG_MODELS))
def test_launch_args_at_the_configurations_pools(model, batch, dtype):
    """What the kernel relies on: the arguments in its order, a grid that
    covers the output and is not oversized, strips of 1 to Ho rows, and
    the 16-byte vector at every channel count of the three; and what the
    card needs: every SM gets a block from batch 8 up (GoogLeNet b8's 7x7
    pools too)."""
    for name, shape, kernel, stride, padding in _max_pools(model, batch):
        out_size = _out_size(shape, kernel, stride, padding)
        la = maxpool.launch_args(shape, dtype, kernel, stride, padding,
                                 out_size, H100_SMS)
        n, h, w, c = shape
        ho, wo = out_size
        assert la.out_shape == (n, ho, wo, c), name
        assert list(la.dims) == [n, h, w, c, ho, wo, *kernel, *stride,
                                 *padding, la.lanes, la.rows, la.threads,
                                 la.blocks], name
        assert c % la.lanes == 0
        assert la.lanes * torch.finfo(dtype).bits // 8 == 16, name
        assert 1 <= la.rows <= ho, name
        total = _threads(la)
        assert (la.blocks - 1) * la.threads < total <= la.blocks * la.threads
        assert la.threads in maxpool.BLOCK_THREADS
        if batch >= 8:
            assert la.blocks >= H100_SMS, name


@pytest.mark.parametrize("c,dtype,lanes", [
    (3, torch.bfloat16, 1), (20, torch.bfloat16, 4), (6, torch.bfloat16, 2),
    (832, torch.bfloat16, 8), (3, torch.float32, 1), (20, torch.float32, 4),
    (6, torch.float32, 2), (832, torch.float32, 4)])
def test_vector_is_the_widest_that_divides_c(c, dtype, lanes):
    la = maxpool.launch_args((2, 9, 9, c), dtype, (3, 3), (2, 2), (0, 0),
                             (4, 4), H100_SMS)
    assert la.lanes == lanes
    assert la.blocks * la.threads >= _threads(la)


@pytest.mark.parametrize("case,error", [
    (dict(dtype=torch.float16), TypeError),
    (dict(dtype=torch.float64), TypeError),
    (dict(shape=(9, 9, 8)), ValueError),
    (dict(shape=(2, 0, 9, 8)), ValueError),
    (dict(out_size=(0, 4)), ValueError),
    (dict(stride=(0, 1)), ValueError),
    (dict(padding=(-1, 0)), ValueError),
])
def test_launch_args_refuse_what_the_kernel_does_not_take(case, error):
    kw = dict(shape=(2, 9, 9, 8), dtype=torch.bfloat16, kernel=(3, 3),
              stride=(2, 2), padding=(0, 0), out_size=(4, 4))
    kw.update(case)
    with pytest.raises(error):
        maxpool.launch_args(kw["shape"], kw["dtype"], kw["kernel"],
                            kw["stride"], kw["padding"], kw["out_size"],
                            H100_SMS)


def _plain_launch(x, kernel, stride, padding, out_size):
    return maxpool.max_pool_plain(x, kernel, stride, padding, out_size)


@pytest.mark.parametrize("case", [
    ((2, 13, 13, 8), (3, 3), (2, 2), (0, 0)),
    ((2, 9, 9, 16), (3, 3), (1, 1), (1, 1)),
    ((2, 7, 8, 3), (3, 2), (2, 1), (1, 0))])
def test_autograd_function_gives_the_plain_gradient(monkeypatch, case):
    monkeypatch.setattr(maxpool, "_kernel", _plain_launch)
    shape, kernel, stride, padding = case
    x = _x(shape, seed=4).requires_grad_()
    args = (kernel, stride, padding, _out_size(shape, kernel, stride,
                                               padding))
    y = maxpool._MaxPool.apply(x, *args)
    g = _x(tuple(y.shape), seed=5)
    (got,) = torch.autograd.grad(y, x, g)
    xr = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(maxpool.max_pool_plain(xr, *args), xr, g)
    assert torch.equal(y.detach(), maxpool.max_pool_plain(x.detach(), *args))
    assert torch.equal(got, want)
    with torch.inference_mode():
        out = maxpool._MaxPool.apply(x.detach(), *args)
    assert torch.equal(out, y.detach())
