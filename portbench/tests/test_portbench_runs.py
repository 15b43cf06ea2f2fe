"""Whole runs on the CPU at a small size (the two configurations at 32x32
images, 2 images a query): a sound run is correct; the control and a
broken timed path are not; a cell, mix and metric added as new files and
entries run with no edit to a file that is there; a run without a card
exits 2 and prints nothing."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.system import ReferenceSystem
from portbench.tests.conftest import ROOT

CPU = torch.device("cpu")
CELLS = ["googlenet-block90.tiny", "resnet50-block90.tiny"]
SEED = 2 ** 31 + 11


def run(root, cell, **kw):
    return harness.run_cell(harness.Bench(root), cell, SEED, 0.2, False, CPU,
                            clock=lambda: 1.0, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench_root, cell):
    r = run(bench_root, cell)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"latency_ms_p50", "latency_ms_p95",
                                 "setup_s"}
    assert r["metrics"]["setup_s"]["value"] == 1.0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench_root, cell):
    """The reference in float8 in the program's place."""
    r = run(bench_root, cell, make_system=lambda cfg, t, p, d:
            ReferenceSystem(cfg, t, p, d, "float8_e4m3fn"))
    assert not r["correct"], r["checks"]


def test_altered_answer_is_not_correct(bench_root, monkeypatch):
    """One image's logits permuted where the program's classifier makes
    them."""
    from caffe_escoin_tpu_torch.nn.layers import InnerProductLayer

    forward = InnerProductLayer.forward

    def altered(self, params, inputs, state=None):
        (out,) = forward(self, params, inputs, state)
        out = out.clone()
        out[0] = out[0].roll(1)
        return [out]

    monkeypatch.setattr(InnerProductLayer, "forward", altered)
    r = run(bench_root, CELLS[0])
    assert not r["correct"] and r["failed"] > 0, r["checks"]


def test_added_by_files_and_entries(bench_root):
    """A new traffic mix, a new per-layer metric and a new cell, added as
    new files and new entries of BENCHMARK.json only."""
    home = bench_root / "portbench"
    (home / "traffic" / "tiny-b1.json").write_text(json.dumps({
        "batch": 1, "pool_batches": 3,
        "warmup_seconds": 0.0, "check_fraction": 1.0, "trace_queries": 2,
        "layer_forwards": 1, "why": "added"}))
    (home / "metrics" / "window_queries.new.py").write_text(
        "def read(run):\n    return float(run.queries)\n")
    spec = json.loads((bench_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "googlenet-b1-added",
                              "config": "googlenet-block90",
                              "traffic": "tiny-b1", "chips": 1,
                              "why": "added"})
    for m in spec["end_to_end"]:
        if m["name"] == "latency_ms_p50":
            m["workloads"].append("googlenet-b1-added")
    spec["per_layer"].append({"name": "window_queries.new", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "latency_ms_p50",
                              "workloads": ["googlenet-b1-added"]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(bench_root)
    r = harness.run_cell(bench, "googlenet-b1-added", SEED, 0.1, True, CPU,
                         clock=lambda: 1.0)
    assert r["correct"]
    assert r["metrics"]["window_queries.new"]["value"] >= 3
    assert "device_idle_pct.stream" not in r["metrics"]  # no device here
    r = harness.run_cell(bench, "googlenet-b1-added", SEED, 0.1, False, CPU,
                         clock=lambda: 1.0)
    assert set(r["metrics"]) == {"latency_ms_p50", "setup_s"}


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "resnet50-b32-offline", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
