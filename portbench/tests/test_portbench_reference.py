"""The plain references: blob shapes of ResNet-50 and GoogLeNet as
published, at a small batch, from the table walk and from a forward; the
LRN and BatchNorm arithmetic; the precisions."""

import math

import pytest
import torch

from portbench.reference import googlenet, plain, resnet50
from portbench import weights

RESNET_SHAPES = {"conv1": (2, 112, 112, 64), "pool1": (2, 56, 56, 64),
                 "res2c": (2, 56, 56, 256), "res3d": (2, 28, 28, 512),
                 "res4f": (2, 14, 14, 1024), "res5c": (2, 7, 7, 2048),
                 "pool5": (2, 1, 1, 2048), "fc1000": (2, 1000)}
# Table 1 of the GoogLeNet paper: output size and depth of each stage
GOOGLENET_SHAPES = {"conv1/7x7_s2": (2, 112, 112, 64),
                    "pool1/3x3_s2": (2, 56, 56, 64),
                    "conv2/3x3": (2, 56, 56, 192),
                    "pool2/3x3_s2": (2, 28, 28, 192),
                    "inception_3a/output": (2, 28, 28, 256),
                    "inception_3b/output": (2, 28, 28, 480),
                    "pool3/3x3_s2": (2, 14, 14, 480),
                    "inception_4a/output": (2, 14, 14, 512),
                    "inception_4d/output": (2, 14, 14, 528),
                    "inception_4e/output": (2, 14, 14, 832),
                    "pool4/3x3_s2": (2, 7, 7, 832),
                    "inception_5b/output": (2, 7, 7, 1024),
                    "pool5/7x7_s1": (2, 1, 1, 1024),
                    "loss3/classifier": (2, 1000)}


@pytest.mark.parametrize("arch, want", [(resnet50, RESNET_SHAPES),
                                        (googlenet, GOOGLENET_SHAPES)])
def test_blob_shapes(arch, want):
    table = arch.table()
    walked = plain.shapes(table, (2, 224, 224, 3))
    for blob, shape in want.items():
        assert walked[blob] == shape, blob
    params = weights.make_params(table, (1, 224, 224, 3), 7, "cpu")
    for e in table:
        if e.get("bn"):
            c = e["cout"]
            params[e["name"]].update(mean=torch.zeros(c), var=torch.ones(c))
    x = torch.zeros(2, 224, 224, 3)
    got = plain.forward(table, params, x, outputs=tuple(want))
    for blob, shape in want.items():
        assert tuple(got[blob].shape) == shape, blob


def test_resnet50_parameter_count():
    # 25,557,032 with BatchNorm's 53,120 affine parameters (torchvision's
    # count of the same network); the table has no conv biases
    shapes = plain.weight_shapes(resnet50.table(), (1, 224, 224, 3))
    n = sum(math.prod(s) for w in shapes.values() for s in w.values())
    bn = sum(2 * e["cout"] for e in resnet50.table() if e.get("bn"))
    assert bn == 53120
    assert n + bn == 25557032


def test_lrn_matches_caffe_formula():
    table = [plain.lrn("n", "data", size=5, alpha=1e-2, beta=0.75, k=2.0)]
    x = torch.randn(1, 3, 2, 7)  # NHWC, 7 channels
    y = plain.forward(table, {}, x, outputs=("n",))["n"]
    c = 3
    window = sum(x[..., j] ** 2 for j in range(c - 2, c + 3))
    want = x[..., c] / (2.0 + 1e-2 / 5 * window) ** 0.75
    assert torch.allclose(y[..., c], want, rtol=1e-6)
    edge = sum(x[..., j] ** 2 for j in range(0, 3))
    assert torch.allclose(y[..., 0], x[..., 0] / (2 + 1e-2 / 5 * edge)
                          ** 0.75, rtol=1e-6)


def test_batchnorm_from_raw_statistics_and_calibration():
    e = plain.conv("c", "data", 4, 1, bias=False, bn=True, relu=False)
    w = torch.randn(1, 1, 3, 4)
    p = {"c": {"w": w, "gamma": torch.full((4,), 2.0),
               "beta": torch.full((4,), 0.5)}}
    x = torch.randn(8, 5, 5, 3)
    y = plain.forward([e], p, x, outputs=("c",), calibrate=True)["c"]
    assert torch.allclose(y.mean(dim=(0, 1, 2)), torch.full((4,), 0.5),
                          atol=1e-5)
    raw = torch.einsum("nhwc,co->nhwo", x, w[0, 0])
    assert torch.allclose(p["c"]["mean"], raw.mean(dim=(0, 1, 2)), atol=1e-5)
    # a constant channel gets a tenth of the median live variance
    w[..., 3] = 0
    x2 = torch.randn(8, 5, 5, 3)
    plain.forward([e], p, x2, outputs=("c",), calibrate=True)
    live = p["c"]["var"][:3]
    assert p["c"]["var"][3] == pytest.approx(0.1 * float(live.median()))


@pytest.mark.parametrize("precision, lo, hi", [
    ("bfloat16", 1e-4, 1e-2), ("float8_e4m3fn", 1e-2, 0.2)])
def test_precisions_round_the_operands(precision, lo, hi):
    t = torch.randn(4096)
    err = float(((plain.rounder(precision)(t) - t).norm() / t.norm()))
    assert lo < err < hi


def test_reference_imports_nothing_of_the_program():
    import sys

    assert not any(m.split(".")[0] == "caffe_escoin_tpu_torch"
                   for m in sys.modules if m.startswith("caffe"))
