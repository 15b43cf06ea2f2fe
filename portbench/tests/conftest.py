"""The benchmark's own tests: ``python -m pytest portbench/tests`` (CPU)
and ``python -m pytest -m cuda portbench/tests`` on a machine with the
card. Imports no JAX; whether a card is there is decided in a fixture."""

import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test measures or checks the card")
    return torch.device("cuda", 0)


@pytest.fixture
def bench_root(tmp_path):
    return make_small_root(tmp_path)


def make_small_root(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's data files in a
    temporary root, with small cells for the CPU: a 2-image traffic mix,
    and GoogLeNet at 32x32 images. ResNet-50 keeps its 224x224 images: at
    32x32 its last stage sees 1x1 maps, whose BatchNorm statistics from 8
    calibration images make the seeded net too ill-conditioned for its
    limit."""
    import json

    home = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "reference"):
        shutil.copytree(ROOT / "portbench" / sub, home / sub)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        if cfg["reference"] != "resnet50":
            cfg["input_hwc"] = [32, 32, 3]
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    (home / "traffic" / "tiny-b2.json").write_text(json.dumps({
        "batch": 2, "pool_batches": 2,
        "warmup_seconds": 0.0, "check_fraction": 1.0, "trace_queries": 2,
        "layer_forwards": 1, "why": "CPU test"}))
    for c in spec["configs"]:
        spec["workloads"].append({
            "name": f"{c['name']}.tiny", "config": c["name"],
            "traffic": "tiny-b2", "chips": 1, "why": "CPU test"})
    spec["end_to_end"] = [m for m in spec["end_to_end"]
                          if "workloads" not in m] + [
        dict(m, workloads=m["workloads"] + [
            f"{c['name']}.tiny" for c in spec["configs"]])
        for m in spec["end_to_end"] if m["name"].startswith("latency")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
