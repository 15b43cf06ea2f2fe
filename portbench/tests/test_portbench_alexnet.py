"""The AlexNet configuration (``alexnet-block90``) and the two metrics that
came with it, on the CPU:

* the plain reference's blob shapes as published (the walk and a forward
  at 227x227, batch 2) and its parameter count, 60,965,224 at 1000
  classes;
* whole runs of the tiny cell (2 images a query) through the program, at
  227x227: the shared tiny root shrinks every configuration but
  ResNet-50's to 32x32, where AlexNet's pool5 has no output, so this
  file sets its own copy back. A sound run is correct, the control (the
  reference in float8 in the program's place) is not;
* ``grouped_conv_roofline_pct.offline``: the pruned grouped convs' bounds
  over the device time charged to them, None without a card's peaks,
  without device time, or in a cell with no pruned grouped conv;
* ``grouped_block_fill_pct``: the program's ``align.grouped.*`` counters,
  the same on every seed and below 100; None where no counter or no
  program is loaded.

On the card (``-m cuda``): the cell at 227x227, three seeds, correct.

A run records set-up spans and counters into the program's aggregates:
each test here clears them after it.
"""

import json
import math
import sys

import pytest
import torch

from portbench import counts, harness, program_trace, weights
from portbench.reference import alexnet, plain
from portbench.system import ReferenceSystem
from portbench.tests.conftest import ROOT, make_small_root

CPU = torch.device("cpu")
SEED = 2 ** 31 + 29
CELL = "alexnet-block90.tiny"
GROUPED = ["conv2", "conv4", "conv5"]
# Krizhevsky et al. 2012, Figure 2, in BVLC's deploy form, at batch 2
SHAPES = {"conv1": (2, 55, 55, 96), "norm1": (2, 55, 55, 96),
          "pool1": (2, 27, 27, 96), "conv2": (2, 27, 27, 256),
          "pool2": (2, 13, 13, 256), "conv3": (2, 13, 13, 384),
          "conv4": (2, 13, 13, 384), "conv5": (2, 13, 13, 256),
          "pool5": (2, 6, 6, 256), "fc6": (2, 4096), "fc7": (2, 4096),
          "fc8": (2, 1000)}


@pytest.fixture(autouse=True)
def program_aggregates_cleared():
    yield
    trace = sys.modules.get(program_trace.TRACE_MODULE)
    if trace is not None:
        trace.reset()


@pytest.fixture
def alex_root(tmp_path):
    """The tiny root, AlexNet at its own 227x227 images."""
    root = make_small_root(tmp_path)
    path = root / "portbench" / "configs" / "alexnet-block90.json"
    cfg = json.loads(path.read_text())
    cfg["input_hwc"] = [227, 227, 3]
    path.write_text(json.dumps(cfg))
    return root


def _run(root, cell=CELL, seed=SEED, trace_on=False, **kw):
    return harness.run_cell(harness.Bench(root), cell, seed, 0.1, trace_on,
                            CPU, clock=lambda: 1.0, **kw)


def _traced_run(root, monkeypatch, cell=CELL):
    """A traced tiny run; returns what its readers read."""
    runs = []
    original = harness._traced

    def keep(run, *a):
        runs.append(run)
        return original(run, *a)

    monkeypatch.setattr(harness, "_traced", keep)
    _run(root, cell, trace_on=True)
    (run,) = runs
    return run


def test_blob_shapes():
    table = alexnet.table()
    walked = plain.shapes(table, (2, 227, 227, 3))
    params = weights.make_params(table, (1, 227, 227, 3), 7, "cpu")
    got = plain.forward(table, params, torch.zeros(2, 227, 227, 3),
                        outputs=tuple(SHAPES))
    for blob, shape in SHAPES.items():
        assert walked[blob] == shape, blob
        assert tuple(got[blob].shape) == shape, blob


@pytest.mark.parametrize("classes, want", [(1000, 60965224),
                                           (10, 56909194)])
def test_parameter_count(classes, want):
    # 60,965,224 at 1000 classes (the paper's 60 M; torchvision's
    # ungrouped AlexNet has 61,100,840), fc6-8 holding 58,631,144 of them
    shapes = plain.weight_shapes(alexnet.table(classes), (1, 227, 227, 3))
    n = sum(math.prod(s) for w in shapes.values() for s in w.values())
    assert n == want
    fcs = sum(math.prod(s) for f in ("fc6", "fc7", "fc8")
              for s in shapes[f].values())
    assert fcs == want - 2334080
    assert shapes["conv2"]["w"] == (5, 5, 48, 256)
    assert shapes["conv4"]["w"] == (3, 3, 192, 384)


def test_biases_and_fillers():
    """train_val.prototxt's biases: 0.1 on conv2, conv4, conv5, fc6, fc7;
    msra convs, xavier fcs; every conv and fc with a bias."""
    table = {e["name"]: e for e in alexnet.table()
             if e["type"] in ("conv", "fc")}
    assert all(e["bias"] for e in table.values())
    ones = {n for n, e in table.items() if e["bias_filler"]["value"] == 0.1}
    assert ones == {"conv2", "conv4", "conv5", "fc6", "fc7"}
    assert {e["weight_filler"]["type"] for n, e in table.items()
            if e["type"] == "conv"} == {"msra"}
    assert {e["weight_filler"]["type"] for n, e in table.items()
            if e["type"] == "fc"} == {"xavier"}


def test_sound_run_is_correct_and_the_control_is_not(alex_root):
    r = _run(alex_root)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"latency_ms_p50", "latency_ms_p95",
                                 "setup_s"}
    c = _run(alex_root, make_system=lambda cfg, t, p, d:
             ReferenceSystem(cfg, t, p, d, "float8_e4m3fn"))
    assert not c["correct"], c["checks"]


def test_grouped_conv_roofline_reader(alex_root, monkeypatch):
    run = _traced_run(alex_root, monkeypatch)
    reader = harness.Bench(ROOT).reader("grouped_conv_roofline_pct.offline")
    assert run.pruned_convs == ["conv2", "conv3", "conv4", "conv5"]
    assert reader(run) is None  # no peaks for the CPU
    run.peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert reader(run) is None  # no device time charged on the CPU
    run.layer_us = {n: 40.0 + i for i, n in enumerate(run.pruned)}
    bound = sum(counts.bound_s(run.work[n], run.peak) for n in GROUPED)
    spent = sum(run.layer_us[n] for n in GROUPED) * 1e-6
    assert reader(run) == pytest.approx(100.0 * bound / spent)
    assert 0 < reader(run) < 100
    del run.layer_us["conv4"]
    assert reader(run) is None  # a grouped conv with no device time


def test_grouped_conv_roofline_is_none_without_grouped_convs(
        bench_root, monkeypatch):
    run = _traced_run(bench_root, monkeypatch, "googlenet-block90.tiny")
    run.peak = counts.peaks("NVIDIA H100 80GB HBM3")
    run.layer_us = {n: 10.0 for n in run.pruned}
    reader = harness.Bench(ROOT).reader("grouped_conv_roofline_pct.offline")
    assert reader(run) is None


def test_grouped_block_fill_reader(alex_root, monkeypatch):
    """The same reading on two seeds (the pattern is the configuration's
    own), below 100 (conv2's kept blocks fill half of the view's), None
    once the counters are cleared or without the program."""
    reader = harness.Bench(ROOT).reader("grouped_block_fill_pct")
    from caffe_escoin_tpu_torch.utils import trace

    readings = []
    for seed in (SEED, SEED + 1):
        trace.reset()
        assert reader(None) is None
        _run(alex_root, seed=seed)
        c = trace.snapshot()["counters"]
        assert c["align.grouped.convs"] == 3
        readings.append(reader(None))
        assert readings[-1] == pytest.approx(
            100.0 * c["align.grouped.nnz"] / c["align.grouped.block_slots"])
    assert readings[0] == readings[1]
    assert 0 < readings[0] < 100
    monkeypatch.delitem(sys.modules, program_trace.TRACE_MODULE)
    assert reader(None) is None


@pytest.mark.cuda
def test_cell_on_the_card(card, alex_root):
    """The cell's configuration at 227x227, 2 images a query, three seeds:
    correct on the card, the control not."""
    control = (lambda cfg, t, p, d:
               ReferenceSystem(cfg, t, p, d, "float8_e4m3fn"))
    for seed in (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203):
        r = harness.run_cell(harness.Bench(alex_root), CELL, seed, 0.5,
                             False, card, clock=lambda: 0.0)
        assert r["correct"], (seed, r["checks"])
        assert r["device"]["platform"] == "gpu"
        c = harness.run_cell(harness.Bench(alex_root), CELL, seed, 0.5,
                             False, card, clock=lambda: 0.0,
                             make_system=control)
        assert not c["correct"], (seed, c["checks"])
