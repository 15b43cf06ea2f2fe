"""The layer types the port adds for deploy and TEST-phase nets, each
against the JAX package's layer: one net of the layer alone, the same
seeded numpy inputs and the JAX layer's params carried over
(``params_from_jax``), every top within rtol 1e-5 (ArgMax and Accuracy
exact), and every top's shape from ``init`` (``out_shapes``) the JAX
net's. EscConvolution also keeps the dense route under a sparse net's
policy."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.nn import LayerSpec as JSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import (ConvMode,  # noqa: E402
                                                   ExecutionPolicy)
from caffe_escoin_tpu_torch.nn import LayerSpec, Net  # noqa: E402
from caffe_escoin_tpu_torch.nn import params_from_jax  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import \
    prune_conv_weight  # noqa: E402

X = (2, 5, 6, 4)
LOGITS, LABELS = (6, 10), (6,)
GAUSS = {"type": "gaussian", "std": 1.0}

# (id, type, params, bottom shapes, number of tops; "labels" marks an
# integer bottom, "positive" a positive input)
CASES = [
    ("esc_conv", "EscConvolution", dict(num_output=8, kernel=3, pad=1,
                                        bias_filler=GAUSS), [X], 1),
    ("prelu", "PReLU", {"alpha_init": 0.3}, [X], 1),
    ("prelu_shared", "PReLU", {"channel_shared": True}, [X], 1),
    ("elu", "ELU", {"alpha": 0.7}, [X], 1),
    ("sigmoid", "Sigmoid", {}, [X], 1),
    ("tanh", "TanH", {}, [X], 1),
    ("bnll", "BNLL", {}, [X], 1),
    ("absval", "AbsVal", {}, [X], 1),
    ("power", "Power", {"power": 2.0, "scale": 0.5, "shift": 1.0}, [X], 1),
    ("exp", "Exp", {}, [X], 1),
    ("exp_base2", "Exp", {"base": 2.0, "scale": 0.5, "shift": 0.1}, [X], 1),
    ("log", "Log", {}, ["positive"], 1),
    ("log_base10", "Log", {"base": 10.0, "scale": 2.0, "shift": 0.5},
     ["positive"], 1),
    ("threshold", "Threshold", {"threshold": 0.2}, [X], 1),
    ("flatten", "Flatten", {}, [X], 1),
    ("reshape", "Reshape", {"shape": (2, 6, 20)}, [X], 1),
    ("slice", "Slice", {"slice_points": (1, 3)}, [X], 3),
    ("split", "Split", {}, [X], 2),
    ("crop", "Crop", {"offsets": (1, 2)}, [X, (2, 3, 3, 4)], 1),
    ("tile", "Tile", {"tiles": 3}, [X], 1),
    ("reduction_sum", "Reduction", {}, [X], 1),
    ("reduction_asum", "Reduction", {"operation": "asum", "axis": 1,
                                     "coeff": 0.5}, [X], 1),
    ("reduction_mean", "Reduction", {"operation": "mean", "axis": -1}, [X],
     1),
    ("reduction_sumsq", "Reduction", {"operation": "sumsq", "axis": 2}, [X],
     1),
    ("argmax", "ArgMax", {}, [X], 1),
    ("silence", "Silence", {}, [X], 0),
    ("bias", "Bias", {"filler": GAUSS}, [X], 1),
    ("bias_bottom", "Bias", {}, [X, (4,)], 1),
    ("mvn", "MVN", {}, [X], 1),
    ("mvn_mean_only", "MVN", {"normalize_variance": False}, [X], 1),
    ("dummy", "DummyData", {"shape": (2, 3), "value": 1.5}, [], 1),
    ("softmax_loss", "SoftmaxWithLoss", {}, [LOGITS, "labels"], 1),
    ("softmax_loss_ignore", "SoftmaxWithLoss", {"ignore_label": 2},
     [LOGITS, "labels"], 1),
    ("accuracy", "Accuracy", {}, [LOGITS, "labels"], 1),
    ("accuracy_top3", "Accuracy", {"top_k": 3, "ignore_label": 1},
     [LOGITS, "labels"], 1),
]
EXACT = ("ArgMax", "Accuracy")


def _inputs(bottoms, rng):
    out = {}
    for i, b in enumerate(bottoms):
        if b == "labels":
            out[f"in{i}"] = rng.integers(0, LOGITS[1], LABELS).astype(np.int32)
        elif b == "positive":
            out[f"in{i}"] = rng.uniform(0.2, 3.0, X).astype(np.float32)
        else:
            out[f"in{i}"] = rng.standard_normal(b).astype(np.float32)
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_jax(case):
    _, kind, params, bottoms, n_tops = case
    rng = np.random.default_rng(0)
    xs = _inputs(bottoms, rng)
    names = tuple(xs)
    tops = tuple(f"top{i}" for i in range(n_tops))
    shapes = {k: v.shape for k, v in xs.items()}
    jnet = JNet([JSpec("layer", kind, names, tops=tops, params=params)])
    jparams = jnet.init(jax.random.PRNGKey(0), shapes)
    want = jnet.apply(jparams, xs, return_blobs=True)
    net = Net([LayerSpec("layer", kind, names, tops=tops, params=params)])
    net.init(torch.Generator().manual_seed(0), shapes)
    got = net(params_from_jax(jparams)[0],
              {k: torch.from_numpy(v) for k, v in xs.items()},
              return_blobs=True)
    assert set(got) == set(want) == set(names) | set(tops)
    for t in tops:
        ref = np.asarray(want[t])
        assert net.blob_shapes[t] == tuple(jnet.blob_shapes[t]) == ref.shape
        if kind in EXACT:
            np.testing.assert_array_equal(got[t].numpy(), ref)
        else:
            np.testing.assert_allclose(got[t].numpy(), ref, rtol=1e-5,
                                       atol=1e-6)


def test_esc_convolution_stays_dense_under_a_sparse_policy():
    spec = LayerSpec("esc", "EscConvolution", ("data",),
                     params=dict(num_output=128, kernel=3, pad=1))
    net = Net([spec], policy=ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                                             block_shape=(32, 32)))
    shapes = {"data": (1, 8, 8, 64)}
    params = net.init(torch.Generator().manual_seed(0), shapes)
    params["esc"]["w"] = torch.from_numpy(prune_conv_weight(
        params["esc"]["w"].numpy(), 0.9, (32, 32)))
    aligned = net.weight_align(params)
    assert aligned["esc"].bsc is not None
    assert net.routes(aligned, shapes) == {"esc": "dense"}
    assert net.layers[0].policy.conv_mode == ConvMode.LOWERED_GEMM
