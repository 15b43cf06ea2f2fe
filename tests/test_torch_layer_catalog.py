"""The rest of the layer catalog against the JAX package: Deconvolution,
SPP, Im2col, RNN, LSTM, LSTMUnit, Embed, BatchReindex, Filter, Parameter,
Python, N-D convolution and stochastic pooling (on the cases of
tests/test_layers_extended.py, tests/test_data_layers.py and
tests/test_nd_and_stochastic.py).

Each layer runs alone in a net on the same seeded numpy inputs as the JAX
layer, with the JAX params carried over (``params_from_jax``): every top
within 1e-5 relative in f32 (1e-6 absolute), every top's shape from
``init`` the JAX net's. Filter keeps Caffe's output where the JAX layer
zeroes the dropped items, so its kept rows are compared. Stochastic
pooling's TEST output is the JAX output exactly; its TRAIN draw comes from a
``torch.Generator`` and is held to its properties. Also the registry (the
JAX package's 61 layer types), Deconvolution's ``.caffemodel`` round trip
and bytes, and ``group != 1`` refused."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.nn import LayerSpec as JSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.net import \
    LAYER_REGISTRY as JAX_REGISTRY  # noqa: E402

from caffe_escoin_tpu_torch.nn import LayerSpec, Net  # noqa: E402
from caffe_escoin_tpu_torch.nn import params_from_jax  # noqa: E402
from caffe_escoin_tpu_torch.nn.net import LAYER_REGISTRY  # noqa: E402

GAUSS = {"type": "gaussian", "std": 1.0}
X = (2, 7, 7, 4)
SEQ = (5, 3, 4)  # time-major [T, N, D]

# (id, type, params, bottoms, number of tops). A bottom is a shape (normal
# f32), "positive" (f32 in [0.2, 3)), "cont" (the [T, N] indicator with 0 at
# t = 0), "cont_n" (a [N] indicator, one 0), "idx" (int32 in [0, 10)) or
# ("reindex", k) (k int32 batch indices)
CASES = [
    ("deconv_s2", "Deconvolution", dict(num_output=6, kernel=4, stride=2,
                                        pad=1, bias_filler=GAUSS), [X], 1),
    ("deconv_dil2", "Deconvolution", dict(num_output=3, kernel=3, pad=2,
                                          dilation=2, bias_term=False),
     [X], 1),
    ("deconv_k1", "Deconvolution", dict(num_output=5, kernel=1,
                                        bias_filler=GAUSS), [X], 1),
    ("spp", "SPP", {}, [(2, 9, 11, 5)], 1),
    ("spp_h2", "SPP", {"pyramid_height": 2}, [(2, 6, 7, 3)], 1),
    ("spp_avg", "SPP", {"mode": "avg"}, [(2, 8, 8, 3)], 1),
    ("im2col", "Im2col", dict(kernel=3, stride=2, pad=1), [X], 1),
    ("im2col_dil", "Im2col", dict(kernel=2, dilation=2), [X], 1),
    ("rnn", "RNN", dict(num_output=6, bias_filler=GAUSS), [SEQ, "cont"], 1),
    ("lstm", "LSTM", dict(num_output=5, bias_filler=GAUSS), [SEQ, "cont"],
     1),
    ("lstm_unit", "LSTMUnit", {}, [(3, 5), (3, 20), "cont_n"], 2),
    ("embed", "Embed", dict(input_dim=10, num_output=6), ["idx"], 1),
    ("batch_reindex", "BatchReindex", {}, [(4, 3), ("reindex", 5)], 1),
    ("parameter", "Parameter", dict(shape=(3, 2), filler=GAUSS), [], 1),
    ("conv3d_grouped", "Convolution", dict(num_output=6, kernel=3, pad=1,
                                           group=2), [(2, 4, 5, 6, 4)], 1),
    ("conv3d_strided", "Convolution", dict(num_output=5, kernel=3,
                                           stride=(2, 2, 2),
                                           pad=(0, 1, 0)),
     [(2, 6, 7, 8, 4)], 1),
    ("conv3d_dilated", "Convolution", dict(num_output=5, kernel=3, pad=2,
                                           dilation=2), [(2, 6, 7, 8, 4)],
     1),
    ("conv1d", "Convolution", dict(num_output=6, kernel=3, pad=1,
                                   bias_filler=GAUSS), [(2, 10, 4)], 1),
    ("stochastic_test", "Pooling", dict(kernel=2, stride=2,
                                        mode="stochastic"),
     ["positive"], 1),
    ("stochastic_test_ceil", "Pooling", dict(kernel=3, stride=2,
                                             mode="stochastic"),
     ["positive"], 1),
]


def _inputs(bottoms, rng):
    out = {}
    for i, b in enumerate(bottoms):
        if b == "positive":
            v = rng.uniform(0.2, 3.0, X).astype(np.float32)
        elif b == "cont":
            v = np.ones(SEQ[:2], np.float32)
            v[0] = 0
        elif b == "cont_n":
            v = np.ones(3, np.float32)
            v[1] = 0
        elif b == "idx":
            v = rng.integers(0, 10, (4, 3)).astype(np.int32)
        elif isinstance(b, tuple) and b[0] == "reindex":
            v = rng.integers(0, 4, b[1]).astype(np.int32)
        else:
            v = rng.standard_normal(b).astype(np.float32)
        out[f"in{i}"] = v
    return out


def _pair_of_nets(kind, params, xs, tops):
    names = tuple(xs)
    shapes = {k: v.shape for k, v in xs.items()}
    jnet = JNet([JSpec("layer", kind, names, tops=tops, params=params)])
    jparams = jnet.init(jax.random.PRNGKey(0), shapes)
    net = Net([LayerSpec("layer", kind, names, tops=tops, params=params)],
              device="cpu")
    net.init(torch.Generator().manual_seed(0), shapes)
    return jnet, jparams, net


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_jax(case):
    _, kind, params, bottoms, n_tops = case
    xs = _inputs(bottoms, np.random.default_rng(0))
    tops = tuple(f"top{i}" for i in range(n_tops))
    jnet, jparams, net = _pair_of_nets(kind, params, xs, tops)
    want = jnet.apply(jparams, {k: jnp.asarray(v) for k, v in xs.items()},
                      return_blobs=True)
    got = net(params_from_jax(jparams)[0],
              {k: torch.from_numpy(v) for k, v in xs.items()},
              return_blobs=True)
    for t in tops:
        ref = np.asarray(want[t])
        assert net.blob_shapes[t] == tuple(jnet.blob_shapes[t]) == ref.shape
        assert got[t].dtype == torch.float32
        if kind == "Pooling":  # stochastic TEST: the JAX output exactly
            np.testing.assert_array_equal(got[t].numpy(), ref)
        np.testing.assert_allclose(got[t].numpy(), ref, rtol=1e-5,
                                   atol=1e-6)


def test_filter_keeps_caffes_rows():
    """Filter's tops: the kept items only (Caffe), where the JAX layer
    zeroes the dropped ones; the selector mask equals the JAX one."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 3, 2)).astype(np.float32)
    sel = np.array([1, 0, 2, 0, 0, 1], np.float32)
    xs = {"x": x, "sel": sel}
    jnet, jparams, net = _pair_of_nets("Filter", {}, xs, ("y", "mask"))
    want = jnet.apply(jparams, {k: jnp.asarray(v) for k, v in xs.items()})
    got = net({}, {k: torch.from_numpy(v) for k, v in xs.items()})
    mask = np.asarray(want["mask"])
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_array_equal(got["y"].numpy(),
                                  np.asarray(want["y"])[mask != 0])
    np.testing.assert_array_equal(got["y"].numpy(), x[sel != 0])
    assert net.blob_shapes["y"] == (6, 3, 2)  # the upper bound
    assert not net.layers[0].graph_safe


def test_python_layer_resolves_user_class(tmp_path, monkeypatch):
    """``type: "Python"`` with python_param {module, layer} resolves the
    user's Layer subclass, from a LayerSpec and from prototxt text."""
    import sys

    (tmp_path / "torch_userlayers.py").write_text(
        "from caffe_escoin_tpu_torch.nn import Layer\n"
        "class DoubleLayer(Layer):\n"
        "    def forward(self, params, inputs, state=None):\n"
        "        return [inputs[0] * 2.0]\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    sys.modules.pop("torch_userlayers", None)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    net = Net([LayerSpec("dbl", "Python", ("data",), ("dbl",),
                         params=dict(module="torch_userlayers",
                                     layer="DoubleLayer"))])
    assert type(net.layers[0]).__name__ == "DoubleLayer"
    net.init(torch.Generator().manual_seed(0), {"data": (2, 3)})
    torch.testing.assert_close(net({}, {"data": x})["dbl"], x * 2.0)

    from caffe_escoin_tpu_torch.tools.prototxt import net_from_prototxt

    specs, shapes, _ = net_from_prototxt('''
name: "pynet"
layer { name: "data" type: "Input" top: "data"
        input_param { shape { dim: 2 dim: 3 } } }
layer { name: "dbl" type: "Python" bottom: "data" top: "dbl"
        python_param { module: "torch_userlayers" layer: "DoubleLayer" } }
''')
    net2 = Net(specs)
    net2.init(torch.Generator().manual_seed(0), shapes)
    torch.testing.assert_close(net2({}, {"data": x})["dbl"], x * 2.0)
    with pytest.raises(TypeError, match="must subclass"):
        Net([LayerSpec("bad", "Python", ("data",),
                       params=dict(module="torch", layer="Tensor"))])


def _stochastic_net():
    return Net([LayerSpec("p", "Pooling", ("x",), params=dict(
        kernel=2, stride=2, mode="stochastic"))], device="cpu")


def test_stochastic_pool_train_samples_window_members():
    """Each sample is an element of its window, drawn in proportion to the
    activations (test_stochastic_pooling.cpp's membership and distribution
    checks); the same generator seed draws the same samples."""
    x = np.abs(np.random.default_rng(0).standard_normal(
        (1, 4, 4, 2)).astype(np.float32)) + 0.1
    net = _stochastic_net()
    xt = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    vals = []
    for _ in range(300):
        o = net({}, {"x": xt}, train=True, generator=gen)["p"].numpy()
        for i in range(2):
            for j in range(2):
                win = x[0, 2 * i:2 * i + 2, 2 * j:2 * j + 2, :]
                for ch in range(2):
                    assert np.isclose(win[..., ch], o[0, i, j, ch],
                                      atol=1e-6).any()
        vals.append(o[0, 0, 0, 0])
    win = x[0, :2, :2, 0].ravel()
    vals = np.asarray(vals)
    frac = [np.isclose(vals, v, atol=1e-6).mean() for v in win]
    assert frac[int(win.argmax())] > frac[int(win.argmin())]
    # each element's share within 0.1 of its probability a / sum(a)
    np.testing.assert_allclose(frac, win / win.sum(), atol=0.1)
    a = net({}, {"x": xt}, train=True,
            generator=torch.Generator().manual_seed(5))["p"]
    b = net({}, {"x": xt}, train=True,
            generator=torch.Generator().manual_seed(5))["p"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stochastic_pool_zero_window_and_generator():
    net = _stochastic_net()
    x = torch.zeros((1, 2, 2, 1))
    assert net({}, {"x": x})["p"].item() == 0.0
    assert net({}, {"x": x}, train=True,
               generator=torch.Generator().manual_seed(0))["p"].item() == 0.0
    with pytest.raises(ValueError, match="generator"):
        net({}, {"x": x + 1}, train=True)
    assert net.layers[0].uses_generator


def test_registry_is_the_jax_packages():
    assert len(LAYER_REGISTRY) == 61
    assert set(LAYER_REGISTRY) == set(JAX_REGISTRY)


def test_deconvolution_refuses_groups():
    with pytest.raises(ValueError, match="group"):
        Net([LayerSpec("d", "Deconvolution", ("x",),
                       params=dict(num_output=4, kernel=2, group=2))])


def test_deconvolution_caffemodel_round_trip(tmp_path):
    """The blob is Caffe's [Cin, Cout, KH, KW]; the port writes the JAX
    package's bytes and reads them back to the same params."""
    from caffe_escoin_tpu.tools.caffemodel import \
        save_caffemodel as jax_save

    from caffe_escoin_tpu_torch.tools.caffemodel import (assign_to_params,
                                                         load_caffemodel,
                                                         save_caffemodel)

    specs = [("up", "Deconvolution", ("x",),
              dict(num_output=6, kernel=4, stride=2, pad=1,
                   bias_filler=GAUSS))]
    shapes = {"x": (1, 5, 5, 3)}
    jnet = JNet([JSpec(*s[:3], params=s[3]) for s in specs])
    jparams = jnet.init(jax.random.PRNGKey(0), shapes)
    net = Net([LayerSpec(*s[:3], params=s[3]) for s in specs])
    params = params_from_jax(jparams)[0]
    net.init(torch.Generator().manual_seed(0), shapes)
    mine, theirs = tmp_path / "port.caffemodel", tmp_path / "jax.caffemodel"
    assert save_caffemodel(net, params, str(mine), log=lambda *_: None) == 1
    jax_save(jnet, jparams, str(theirs), log=lambda *_: None)
    assert mine.read_bytes() == theirs.read_bytes()
    loaded = load_caffemodel(str(mine))
    assert loaded["up"]["blobs"][0].shape == (3, 6, 4, 4)
    fresh = net.init(torch.Generator().manual_seed(1), shapes)
    back = assign_to_params(net, fresh, loaded, log=lambda *_: None)
    for k in ("w", "b"):
        torch.testing.assert_close(back["up"][k], params["up"][k], rtol=0,
                                   atol=0)


def test_params_from_jax_carries_the_new_layers():
    """Deconvolution, the recurrent weights, Embed and Parameter cross with
    their keys and shapes, and the port's init gives the same ones."""
    specs = [
        ("up", "Deconvolution", ("x",), dict(num_output=4, kernel=2,
                                             stride=2)),
        ("lstm", "LSTM", ("seq", "cont"), dict(num_output=5)),
        ("rnn", "RNN", ("seq", "cont"), dict(num_output=3)),
        ("emb", "Embed", ("idx",), dict(input_dim=7, num_output=2)),
        ("par", "Parameter", (), dict(shape=(2, 3))),
    ]
    shapes = {"x": (1, 3, 3, 2), "seq": (4, 2, 3), "cont": (4, 2),
              "idx": (5,)}
    jparams = JNet([JSpec(*s[:3], params=s[3]) for s in specs]).init(
        jax.random.PRNGKey(0), shapes)
    mine = Net([LayerSpec(*s[:3], params=s[3]) for s in specs]).init(
        torch.Generator().manual_seed(0), shapes)
    carried = params_from_jax(jparams)[0]
    assert set(carried) == set(mine) == {s[0] for s in specs}
    for name, blobs in carried.items():
        assert set(blobs) == set(mine[name])
        for k, v in blobs.items():
            assert tuple(v.shape) == tuple(mine[name][k].shape)
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(jparams[name][k]))


@pytest.mark.parametrize("k,s,p,hw", [(2, 2, 1, 7), (3, 2, 1, 9),
                                      (3, 3, 0, 8), (4, 3, 2, 11)])
def test_average_pool_with_any_padding_divides_as_caffe(k, s, p, hw):
    """SPP pads up to the whole window minus one, which torch's pooling
    refuses beyond half a window; that path (``_avg_clipped``) gives what
    the usual one gives where both apply, and Caffe's clipped divisor on a
    window past the padded input (checked by a scalar oracle)."""
    from caffe_escoin_tpu_torch.ops import pool as pool_ops

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, hw, hw, 3)).astype(np.float32))
    ho = pool_ops._pooled_size(hw, k, s, p, True)
    got = pool_ops._avg_clipped(x, (k, k), (s, s), (p, p), ho, ho)
    if 2 * p <= k:
        torch.testing.assert_close(got, pool_ops.pool2d(
            x, (k, k), stride=(s, s), padding=(p, p), mode="avg"))
    xn = x.numpy()
    for i in range(ho):
        for j in range(ho):
            h0, w0 = i * s - p, j * s - p
            h1, w1 = min(h0 + k, hw + p), min(w0 + k, hw + p)
            win = xn[:, max(h0, 0):min(h1, hw), max(w0, 0):min(w1, hw)]
            np.testing.assert_allclose(
                got[:, i, j].numpy(),
                win.sum(axis=(1, 2)) / ((h1 - h0) * (w1 - w0)), rtol=1e-5,
                atol=1e-6)
    spp = pool_ops.spp(x, 3, mode="avg")
    assert spp.shape == (2, 3 * 21) and torch.isfinite(spp).all()
