"""BENCHMARK.json and the files it names: each loads by name, and every
name, unit and entry keeps to the benchmark's contract."""

import json
import re

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
# what the harness reads of a traffic mix, and nothing else
MIX_KEYS = {"batch", "pool_batches", "warmup_seconds", "check_fraction",
            "trace_queries", "layer_forwards", "why"}
AHEAD_KEYS = {"ahead_seconds", "ahead_max"}


def test_top_level():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keys_and_names(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads_and_reports(cell):
    bench = harness.Bench(ROOT)
    w = bench.cell(cell)
    assert w["chips"] == 1
    cfg = bench.config(w["config"])
    mix = bench.traffic(w["traffic"])
    bench.reference(cfg["reference"]).table(cfg["num_classes"])
    assert set(mix) in (MIX_KEYS, MIX_KEYS | AHEAD_KEYS), cell
    assert set(cfg["limits"]) == {"logit_rel_err"}
    e2e = {m["name"] for m in bench.metrics_of(cell, "end_to_end")}
    layer = bench.metrics_of(cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
    for m in bench.metrics_of(cell, "end_to_end") + layer:
        assert callable(bench.reader(m["name"]))


def test_config_files():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)


def test_layers_named_alike():
    """Metrics of one layer name it letter for letter; every per-layer
    metric lists its cells."""
    for m in SPEC["per_layer"]:
        assert m["workloads"], m["name"]
        assert len(m["layer"].splitlines()) == 1


def test_reader_of_a_split_quantity(tmp_path):
    """A metric ``<x>.<suffix>`` with no file of its own is read by
    ``<x>.py``; a file of its own comes first."""
    bench = harness.Bench(ROOT)
    assert bench.reader("device_idle_pct.offline").__code__.co_filename \
        == bench.reader("device_idle_pct.stream").__code__.co_filename
    home = tmp_path / "portbench" / "metrics"
    home.mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(SPEC))
    (home / "q.py").write_text("def read(run):\n    return 1.0\n")
    (home / "q.b.py").write_text("def read(run):\n    return 2.0\n")
    other = harness.Bench(tmp_path)
    assert other.reader("q.a")(None) == 1.0
    assert other.reader("q.b")(None) == 2.0
    with pytest.raises(FileNotFoundError):
        other.reader("r.a")
