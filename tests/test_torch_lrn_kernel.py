"""The LRN kernel's wrapper (``kernels/lrn.py``) on the CPU.

A CPU tensor takes the plain version (the former ``ops/norm.py`` chain,
bit for bit) and launches nothing; the launch arguments that the CUDA
kernel reads are whole pixels of whole 16-byte vectors per tile, enough
tiles to fill the card at GoogLeNet's batch-8 maps, and the window's offsets
as the plain version takes them; the ``torch.autograd.Function`` around the
launch gives the plain version's gradient (checked with the launch replaced
by the plain forward, since the kernel runs only on the card; its own
parity is in tests/test_torch_cuda.py); and the trace lists the kernel
beside the ports of the Pallas kernels.
"""

import math

import numpy as np
import pytest
import torch

from caffe_escoin_tpu_torch.kernels import lrn
from caffe_escoin_tpu_torch.nn import LayerSpec, Net
from caffe_escoin_tpu_torch.ops import norm as norm_ops
from caffe_escoin_tpu_torch.utils import trace

H100_SMS = 132
# GoogLeNet's norm1 and norm2 at batch 32 and 8, and the packed norm1
ZOO_MAPS = [(32, 56, 56, 64), (32, 56, 56, 192), (8, 56, 56, 64),
            (8, 56, 56, 192), (8, 56, 28, 128)]
ODD_MAPS = [(2, 5, 6, 24), (3, 5, 7, 20), (2, 3, 5, 3), (1, 1, 1, 1),
            (1, 2, 2, 4100)]


def _x(shape, seed=0, scale=3.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
def test_cpu_takes_the_plain_version(dtype, groups):
    x = _x((2, 4, 5, 24)).to(dtype)
    kw = dict(local_size=5, alpha=1e-2, beta=0.75, k=2.0, groups=groups)
    calls, launches = lrn.calls, lrn.launches
    got = norm_ops.lrn_across_channels(x, **kw)
    assert (lrn.calls, lrn.launches) == (calls + 1, launches)
    assert got.dtype == dtype
    assert torch.equal(got, lrn.lrn_plain(x, **kw))


def test_lrn_layer_goes_through_the_wrapper():
    net = Net([LayerSpec("norm", "LRN", ("data",), ("n",),
                         params=dict(local_size=5, alpha=1e-4, beta=0.75))])
    x = _x((1, 3, 3, 16), seed=1, scale=30.0)
    calls = lrn.calls
    out = net.apply({}, {"data": x})["n"]
    assert lrn.calls == calls + 1
    assert torch.equal(out, lrn.lrn_plain(x))


def test_kernel_counts_and_snapshot_list_lrn():
    assert "lrn" in trace.OP_KERNELS and "lrn" not in trace.KERNELS
    counts = trace.kernel_counts()
    assert set(counts) == set(trace.KERNELS + trace.OP_KERNELS)
    assert counts["lrn"] == {"calls": lrn.calls, "launches": lrn.launches,
                             "launches_f32": lrn.launches_f32}
    assert trace.snapshot()["kernels"]["lrn"] == counts["lrn"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ZOO_MAPS + ODD_MAPS)
def test_tiles_are_whole_pixels_of_whole_vectors(shape, dtype):
    itemsize = torch.finfo(dtype).bits // 8
    pixels, c = math.prod(shape[:-1]), shape[-1]
    tile = lrn.tile_elems(pixels, c, itemsize, H100_SMS)
    assert tile % c == 0 and tile * itemsize % 16 == 0
    step = (16 // itemsize) // math.gcd(c, 16 // itemsize)
    assert tile * itemsize <= lrn.TILE_BYTES or tile == step * c
    if shape in ZOO_MAPS:  # even batch 8 gives several tiles per SM
        blocks = -(-pixels * c // tile)
        assert blocks >= 4 * H100_SMS, blocks


@pytest.mark.parametrize("beta", [0.75, 0.5])
@pytest.mark.parametrize("local_size,lo,hi", [(5, -2, 2), (4, -2, 1),
                                              (1, 0, 0), (3, -1, 1)])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_launch_args_are_the_plain_window(groups, local_size, lo, hi, beta):
    shape = (2, 3, 5, 48)
    dims, floats = lrn.launch_args(shape, torch.bfloat16, local_size, 1e-4,
                                   beta, 1.0, groups, H100_SMS)
    tile = lrn.tile_elems(30, 48, 2, H100_SMS)
    assert list(dims) == [30, 48, 48 // groups, lo, hi, tile,
                          int(beta != 0.75)]
    assert list(floats) == [np.float32(1e-4 / local_size), 1.0,
                            np.float32(-beta)]


@pytest.mark.parametrize("case,error", [
    (dict(dtype=torch.float16), TypeError),
    (dict(dtype=torch.float64), TypeError),
    (dict(local_size=6), ValueError),
    (dict(local_size=0), ValueError),
    (dict(groups=5), ValueError),
    (dict(shape=(1, 1, 1, 30000)), ValueError),
])
def test_launch_args_refuse_what_the_kernel_does_not_take(case, error):
    kw = dict(shape=(2, 3, 5, 48), dtype=torch.bfloat16, local_size=5,
              groups=2)
    kw.update(case)
    with pytest.raises(error):
        lrn.launch_args(kw["shape"], kw["dtype"], kw["local_size"], 1e-4,
                        0.75, 1.0, kw["groups"], H100_SMS)


def _plain_launch(x, local_size, alpha, beta, k, groups):
    return lrn.lrn_plain(x, local_size=local_size, alpha=alpha, beta=beta,
                         k=k, groups=groups)


@pytest.mark.parametrize("groups,local_size,beta", [(1, 5, 0.75),
                                                    (2, 4, 0.5)])
def test_autograd_function_gives_the_plain_gradient(monkeypatch, groups,
                                                    local_size, beta):
    monkeypatch.setattr(lrn, "_kernel", _plain_launch)
    kw = dict(local_size=local_size, alpha=1e-2, beta=beta, k=2.0,
              groups=groups)
    x = _x((2, 3, 4, 16), seed=2).requires_grad_()
    g = _x((2, 3, 4, 16), seed=3)
    y = lrn._LRN.apply(x, *kw.values())
    (got,) = torch.autograd.grad(y, x, g)
    xr = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(lrn.lrn_plain(xr, **kw), xr, g)
    assert torch.equal(y.detach(), lrn.lrn_plain(x.detach(), **kw))
    assert torch.equal(got, want)
    with torch.inference_mode():
        out = lrn._LRN.apply(x.detach(), *kw.values())
    assert torch.equal(out, y.detach())


def test_plain_masks_built_in_inference_mode_serve_a_gradient():
    """A packed LRN's lane masks, first built by an inference forward (as
    the card's graph capture builds them), also serve a training forward."""
    x = _x((1, 2, 2, 36), seed=4)
    with torch.inference_mode():
        lrn.lrn_plain(x, groups=3)
    xr = x.clone().requires_grad_()
    lrn.lrn_plain(xr, groups=3).sum().backward()
    assert torch.isfinite(xr.grad).all()
