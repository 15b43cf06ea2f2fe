"""The native host library (data/native.py) against the JAX package's
bindings of the same C++ sources: the build into build/native/ (nothing
written under csrc/), the prefetching ``.cerec`` loader, the BSC packer,
the blocked direct sparse conv and the ``native_cpu`` route of the conv
dispatcher (the cases of tests/test_native_sconv.py). Skipped only where
there is no ``g++``, as the JAX tests skip without their library."""

import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native library")

from caffe_escoin_tpu.data import native as jnative  # noqa: E402
from caffe_escoin_tpu.engine.context import \
    ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.ops import conv as jconv  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import \
    weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.data import datasets, native  # noqa: E402
from caffe_escoin_tpu_torch.engine.context import (  # noqa: E402
    ConvMode, ExecutionPolicy)
from caffe_escoin_tpu_torch.ops import conv as conv_ops  # noqa: E402
from caffe_escoin_tpu_torch.sparse import dense_to_bsc  # noqa: E402
from caffe_escoin_tpu_torch.sparse.weight_align import \
    weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import \
    prune_conv_weight  # noqa: E402

CSRC = native.CSRC


def _csrc_state():
    return {p.name: (p.stat().st_mtime_ns, p.stat().st_size)
            for p in CSRC.iterdir()}


def test_library_builds_into_build_native_only(tmp_path, monkeypatch):
    """A fresh build writes its library under the build directory, keyed
    by a hash, and leaves csrc/ as it was."""
    before = _csrc_state()
    assert native.BUILD_DIR == native.ROOT / "build" / "native"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    so = native.build()
    assert so.parent == tmp_path / "native" and so.exists()
    assert so.name.startswith("libcescoin_") and so.suffix == ".so"
    assert native.build() == so  # built once, then reused
    assert [p.name for p in (tmp_path / "native").iterdir()
            if p.suffix == ".so"] == [so.name]
    assert _csrc_state() == before
    lib = native.load_library()
    assert lib is not None and native.build_error is None


@pytest.fixture
def cerec(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((13, 4, 3, 2)).astype(np.float32)
    path = str(tmp_path / "d.cerec")
    datasets.write_cerec(path, data, np.arange(13))
    return path, data


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_loader_batches_equal_the_jax_loaders(cerec, shuffle):
    """One worker: the same file, seed and shuffle give the JAX loader's
    batches, in order."""
    path, _ = cerec
    kw = dict(shuffle=shuffle, seed=7, workers=1, capacity=2)
    with native.NativeCerecLoader(path, 5, (4, 3, 2), **kw) as mine, \
            jnative.NativeCerecLoader(path, 5, (4, 3, 2), **kw) as theirs:
        assert mine.num == theirs.num == 13
        for _ in range(6):
            a, b = next(mine), next(theirs)
            assert a["data"].dtype == np.float32
            assert a["label"].dtype == np.int32
            np.testing.assert_array_equal(a["data"], b["data"])
            np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_loader_two_workers_serve_records(cerec, shuffle):
    """Two workers race for the queue, so only each row is fixed: the
    record its label names."""
    path, data = cerec
    with native.NativeCerecLoader(path, 4, (4, 3, 2), shuffle=shuffle,
                                  seed=1, workers=2) as loader:
        for _ in range(8):
            batch = next(loader)
            assert batch["data"].shape == (4, 4, 3, 2)
            np.testing.assert_array_equal(batch["data"],
                                          data[batch["label"]])
    with pytest.raises(StopIteration):
        next(loader)  # closed


def test_native_loader_refuses_a_wrong_shape_and_no_library(cerec,
                                                            monkeypatch):
    path, _ = cerec
    with pytest.raises(ValueError, match="24 elements"):
        native.NativeCerecLoader(path, 2, (5, 5))
    monkeypatch.setattr(native, "load_library", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeCerecLoader(path, 2, (4, 3, 2))
    assert native.native_bsc_pack(np.ones((4, 4), np.float32),
                                  (2, 2)) is None


def test_native_bsc_pack_equals_dense_to_bsc():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((512, 384)).astype(np.float32)
    w[np.abs(w) < 1.2] = 0  # about 75% zeros, an irregular pattern
    bsc = dense_to_bsc(w, (128, 128))
    blocks, rows, nnz, max_bw = native.native_bsc_pack(w, (128, 128))
    assert max_bw == bsc.max_bw
    np.testing.assert_array_equal(nnz, bsc.bcol_nnz.numpy())
    np.testing.assert_array_equal(rows, bsc.block_row.numpy())
    np.testing.assert_array_equal(blocks, bsc.blocks.numpy())


SCONV_CASES = [  # tests/test_native_sconv.py's
    (8, 8, 32, 32, 3, 1, 1, True, False),
    (9, 7, 32, 48, 3, 2, 1, True, True),
    (8, 8, 32, 32, 5, 1, 2, False, False),
    (7, 7, 48, 32, 1, 1, 0, True, True),
    (8, 8, 16, 16, 3, 1, 0, False, False),
]


def _weights(rng, k, cin, cout, bias, groups=1, sparsity=0.7):
    w = prune_conv_weight(rng.standard_normal(
        (k, k, cin // groups, cout)).astype(np.float32), sparsity, (16, 16))
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    return w, b


@pytest.mark.parametrize("h,w,cin,cout,k,stride,pad,bias,relu",
                         SCONV_CASES)
def test_native_sconv_equals_the_jax_binding(h, w, cin, cout, k, stride,
                                             pad, bias, relu):
    """The same C++ function on the port's aligned weight and on the JAX
    package's: the same output, bit for bit; and the dense conv's within
    1e-5."""
    rng = np.random.default_rng(0)
    w_, b = _weights(rng, k, cin, cout, bias)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    kw = dict(padding=(pad, pad), stride=(stride, stride), relu=relu)
    mine = native.native_bsc_sconv(x, weight_align(
        w_, b, policy=ExecutionPolicy(block_shape=(16, 16))), **kw)
    theirs = jnative.native_bsc_sconv(x, jweight_align(
        jnp.asarray(w_), None if b is None else jnp.asarray(b),
        policy=JPolicy(block_shape=(16, 16))), **kw)
    np.testing.assert_array_equal(mine, theirs)
    ref = conv_ops.conv2d_dense(
        torch.from_numpy(x), torch.from_numpy(w_),
        None if b is None else torch.from_numpy(b), stride=(stride, stride),
        padding=(pad, pad), relu=relu).numpy()
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5)


def test_native_sconv_grouped():
    rng = np.random.default_rng(1)
    w_, _ = _weights(rng, 3, 32, 32, False, groups=2, sparsity=0.6)
    al = weight_align(w_, None, groups=2,
                      policy=ExecutionPolicy(block_shape=(16, 16)))
    x = rng.standard_normal((1, 8, 8, 32)).astype(np.float32)
    out = native.native_bsc_sconv(x, al, padding=(1, 1))
    ref = conv_ops.conv2d_dense(torch.from_numpy(x), torch.from_numpy(w_),
                                padding=(1, 1), groups=2).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


ROUTE_CASES = [  # (k, stride, pad, dilation, residual, native runs)
    (3, 1, 1, 1, True, True),
    (3, 1, 1, 1, False, True),
    (1, 2, 0, 1, False, True),  # strided 1x1: subsampled, then native
    (3, 2, 1, 1, False, False),  # strided k>1: the dense route
    (3, 1, 2, 2, False, False),  # dilation: the XBSP arms
]


@pytest.mark.parametrize("k,stride,pad,dil,with_res,runs", ROUTE_CASES)
def test_native_cpu_route_equals_the_jax_route(monkeypatch, k, stride, pad,
                                               dil, with_res, runs):
    """``native_cpu`` on a CPU tensor routes conv2d (SCONV_PAR) and
    conv2d_sconv through the C++ kernel where the JAX gate does, with the
    residual added before the ReLU, and gives the JAX route's output."""
    rng = np.random.default_rng(2)
    w_, b = _weights(rng, k, 32, 32, True)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    ho = (8 + 2 * pad - dil * (k - 1) - 1) // stride + 1
    res = rng.standard_normal((2, ho, ho, 32)).astype(np.float32) \
        if with_res else None
    geo = dict(stride=(stride, stride), padding=(pad, pad),
               dilation=(dil, dil), relu=True)
    jpol = JPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(16, 16),
                   native_cpu=True)
    want = np.asarray(jconv.conv2d(
        jnp.asarray(x), jweight_align(jnp.asarray(w_), jnp.asarray(b),
                                      policy=jpol),
        policy=jpol, residual=None if res is None else jnp.asarray(res),
        **geo))
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(16, 16),
                          native_cpu=True)
    al = weight_align(w_, b, policy=pol)
    calls = []
    real = native.native_bsc_sconv
    monkeypatch.setattr(native, "native_bsc_sconv",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    xt = torch.from_numpy(x)
    rt = None if res is None else torch.from_numpy(res)
    got = conv_ops.conv2d(xt, al, policy=pol, residual=rt, **geo)
    direct = conv_ops.conv2d_sconv(xt, al, policy=pol, residual=rt, **geo)
    assert len(calls) == (2 if runs else 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(direct.numpy(), got.numpy())
    off = conv_ops.conv2d(xt, al, policy=ExecutionPolicy(
        conv_mode=ConvMode.SCONV_PAR, block_shape=(16, 16)), residual=rt,
        **geo)
    np.testing.assert_allclose(off.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_native_cpu_in_a_net_and_bf16():
    """A conv layer under a native_cpu policy runs the host kernel, in bf16
    too (f32 inside, one cast back)."""
    rng = np.random.default_rng(3)
    from caffe_escoin_tpu_torch.nn import LayerSpec, Net

    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV, block_shape=(16, 16),
                          native_cpu=True)
    net = Net([LayerSpec("c", "ConvolutionReLU", ("x",),
                         params=dict(num_output=32, kernel=3, pad=1))],
              policy=pol)
    params = net.init(torch.Generator().manual_seed(0), {"x": (2, 8, 8, 32)})
    params["c"]["w"] = torch.from_numpy(prune_conv_weight(
        params["c"]["w"].numpy(), 0.8, (16, 16)))
    aligned = net.weight_align(params)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 32)).astype(
        np.float32))
    got = net(aligned, {"x": x})["c"]
    ref = Net(net.specs)(params, {"x": x})["c"]
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    got16 = net(aligned, {"x": x.bfloat16()})["c"]
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), ref, rtol=5e-2, atol=5e-2)
