"""The autotuned VGG-16 configuration (``vgg16-block90-autotuned``) and
the two metrics that came with it, on the CPU:

* the plain reference's blob shapes as published (the walk at 224x224, a
  forward at 64x64) and its parameter count, 138,357,544 at 1000 classes;
* whole runs of the tiny cell (32x32 images, 2 a query) through the
  program, autotuned on the CPU's clock: a sound run is correct, the
  control (the reference in float8 in the program's place) is not;
* ``autotune_setup_s``: the self time of the program's ``setup:autotune``
  spans, None where nothing was measured or no program is loaded;
* ``sparse_fc_roofline_pct.offline``: the pruned fcs' bounds over the
  device time charged to them, on a tiny traced run's work and pruned
  layers; None without a card's peaks or device time.

A run records set-up spans into the program's aggregates, which other
tests of this directory read: each test here clears them after it.
"""

import math
import sys

import pytest
import torch

from portbench import counts, harness, program_trace, weights
from portbench.reference import plain, vgg16
from portbench.system import ReferenceSystem
from portbench.tests.conftest import ROOT

CPU = torch.device("cpu")
SEED = 2 ** 31 + 13
VGG = "vgg16-block90-autotuned.tiny"
# Table 1 of the VGG paper, configuration D: each stage's last conv and
# its pool, then the fcs, at batch 2
SHAPES = {"conv1_2": (2, 224, 224, 64), "pool1": (2, 112, 112, 64),
          "conv2_2": (2, 112, 112, 128), "pool2": (2, 56, 56, 128),
          "conv3_3": (2, 56, 56, 256), "pool3": (2, 28, 28, 256),
          "conv4_3": (2, 28, 28, 512), "pool4": (2, 14, 14, 512),
          "conv5_3": (2, 14, 14, 512), "pool5": (2, 7, 7, 512),
          "fc6": (2, 4096), "fc7": (2, 4096), "fc8": (2, 1000)}


@pytest.fixture(autouse=True)
def program_aggregates_cleared():
    yield
    trace = sys.modules.get(program_trace.TRACE_MODULE)
    if trace is not None:
        trace.reset()
    autotune = sys.modules.get("caffe_escoin_tpu_torch.engine.autotune")
    if autotune is not None:
        autotune.clear()


def _run(root, trace_on=False, **kw):
    return harness.run_cell(harness.Bench(root), VGG, SEED, 0.2, trace_on,
                            CPU, clock=lambda: 1.0, **kw)


def test_blob_shapes():
    """The walk at 224x224 gives the published shapes; a forward at 64x64
    gives the walk's shapes there."""
    table = vgg16.table()
    walked = plain.shapes(table, (2, 224, 224, 3))
    for blob, shape in SHAPES.items():
        assert walked[blob] == shape, blob
    at_64 = plain.shapes(table, (2, 64, 64, 3))
    params = weights.make_params(table, (1, 64, 64, 3), 7, "cpu")
    got = plain.forward(table, params, torch.zeros(2, 64, 64, 3),
                        outputs=tuple(SHAPES))
    for blob in SHAPES:
        assert tuple(got[blob].shape) == at_64[blob], blob


@pytest.mark.parametrize("classes, want", [(1000, 138357544),
                                           (10, 134301514)])
def test_parameter_count(classes, want):
    # 138,357,544 at 1000 classes (the paper's 138 M; torchvision's count
    # of the same network), fc6 alone 102,764,544
    shapes = plain.weight_shapes(vgg16.table(classes), (1, 224, 224, 3))
    n = sum(math.prod(s) for w in shapes.values() for s in w.values())
    assert n == want
    assert sum(math.prod(s) for s in shapes["fc6"].values()) == 102764544


def test_sound_run_is_correct_and_the_control_is_not(bench_root):
    r = _run(bench_root)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"latency_ms_p50", "latency_ms_p95",
                                 "setup_s"}
    c = _run(bench_root, make_system=lambda cfg, t, p, d:
             ReferenceSystem(cfg, t, p, d, "float8_e4m3fn"))
    assert not c["correct"], c["checks"]


def test_autotune_setup_reader(bench_root, monkeypatch):
    """One ``setup:autotune`` span a key measured, the three fcs each
    their own; the reader gives their self time. None where nothing was
    measured, or where no program is loaded."""
    reader = harness.Bench(ROOT).reader("autotune_setup_s")
    from caffe_escoin_tpu_torch.engine import autotune
    from caffe_escoin_tpu_torch.utils import trace

    trace.reset()
    autotune.clear()
    assert reader(None) is None
    _run(bench_root)
    snap = trace.snapshot()
    span = snap["spans"]["setup:autotune"]
    measured = snap["counters"]
    assert measured["autotune.measured.fc"] == 3
    assert span["count"] == (measured["autotune.measured.conv"]
                             + measured["autotune.measured.fc"])
    assert reader(None) == pytest.approx(span["self_s"])
    assert span["self_s"] > 0
    monkeypatch.delitem(sys.modules, program_trace.TRACE_MODULE)
    assert reader(None) is None


@pytest.mark.parametrize("cell", ["googlenet-block90.tiny",
                                  "resnet50-block90.tiny", VGG])
def test_sparse_fc_roofline_reader(bench_root, monkeypatch, cell):
    runs = []
    original = harness._traced

    def keep(run, *a):
        runs.append(run)
        return original(run, *a)

    monkeypatch.setattr(harness, "_traced", keep)
    harness.run_cell(harness.Bench(bench_root), cell, SEED, 0.1, True, CPU,
                     clock=lambda: 1.0)
    (run,) = runs
    reader = harness.Bench(ROOT).reader("sparse_fc_roofline_pct.offline")
    fcs = [n for n in run.pruned if n not in run.pruned_convs]
    assert len(fcs) == (3 if cell == VGG else 1)
    assert reader(run) is None  # no peaks for the CPU
    run.peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert reader(run) is None  # no device time charged on the CPU
    run.layer_us = {n: 50.0 * (i + 1) for i, n in enumerate(fcs)}
    bound = sum(counts.bound_s(run.work[n], run.peak) for n in fcs)
    assert reader(run) == pytest.approx(
        100.0 * bound / (sum(run.layer_us.values()) * 1e-6))
    assert reader(run) > 0
