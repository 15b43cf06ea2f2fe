"""The offline loop that sends queries ahead of the one it waits for
(a mix with ``ahead_seconds``), on the CPU:

* ``Ahead`` and ``dispatched`` with a stand-in system whose one output
  tensor every call overwrites, as a CUDA graph's does: every answer
  handed back is its own query's, slots are taken again only once their
  query is on the host, and the window counts every query it sent;
* ``ahead_depth``: the seconds of queries, clamped to 2 and ``ahead_max``;
* whole runs of GoogLeNet's tiny cell (32x32, 2 images a query) under a
  mix sent ahead, traced: the sound run is correct; the control (the
  reference in float8 in the program's place) is not.
"""

import json

import pytest
import torch

from portbench import harness
from portbench.system import ReferenceSystem

CPU = torch.device("cpu")
SEED = 2 ** 31 + 37


class Overwriting:
    """Hands back one output tensor, overwritten by every call."""

    def __init__(self):
        self.out = torch.zeros(2, 3)
        self.calls = 0

    def issue(self, x):
        self.out.copy_(x)
        self.calls += 1
        return {"logits": self.out}

    def logits(self, out):
        return out["logits"]


def test_every_answer_is_its_own():
    pool = torch.arange(5 * 2 * 3, dtype=torch.float32).view(5, 2, 3)
    system = Overwriting()
    ahead = harness.Ahead(system.issue(pool[0])["logits"], depth=3)
    n, window_s, done, kept = harness.dispatched(system, pool, ahead, 0.0,
                                                 keep=lambda m: True)
    assert n == 5 and system.calls == 6 and window_s > 0
    assert not ahead.pending and len(done) == n
    assert done == sorted(done)
    assert [j for j, _ in kept] == [0, 1, 2, 3, 4]
    for j, logits in kept:
        assert torch.equal(logits, pool[j])


def test_a_slot_waits_for_its_query():
    pool = torch.arange(4 * 2 * 3, dtype=torch.float32).view(4, 2, 3)
    system = Overwriting()
    ahead = harness.Ahead(system.issue(pool[0])["logits"], depth=2)
    for n in range(2):
        ahead.send(n, system.logits(system.issue(pool[n])))
    assert ahead.full()
    m, out = ahead.take()
    assert m == 0 and torch.equal(out, pool[0]) and not ahead.full()


def test_window_runs_for_its_time():
    pool = torch.zeros(2, 2, 3)
    system = Overwriting()
    ahead = harness.Ahead(torch.zeros(2, 3), depth=4)
    n, window_s, done, kept = harness.dispatched(system, pool, ahead, 0.05)
    assert window_s >= 0.05 and n == len(done) >= 2 and kept == []


@pytest.mark.parametrize("query_s, depth", [
    (1.0, 4), (0.001, 1024), (10.0, 2), (0.06, 67)])
def test_depth(query_s, depth):
    assert harness.ahead_depth({"ahead_seconds": 4.0, "ahead_max": 1024},
                               query_s) == depth


def _ahead_root(bench_root):
    spec = json.loads((bench_root / "BENCHMARK.json").read_text())
    mix = json.loads((bench_root / "portbench" / "traffic" /
                      "tiny-b2.json").read_text())
    mix.update(ahead_seconds=4.0, ahead_max=3)
    (bench_root / "portbench" / "traffic" / "tiny-b2-ahead.json").write_text(
        json.dumps(mix))
    spec["workloads"].append({
        "name": "googlenet-block90.tiny-ahead", "config": "googlenet-block90",
        "traffic": "tiny-b2-ahead", "chips": 1, "why": "CPU test"})
    for m in spec["per_layer"]:
        if m["name"] == "device_idle_pct.offline":
            m["workloads"].append("googlenet-block90.tiny-ahead")
    (bench_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench_root


def _run(root, **kw):
    return harness.run_cell(harness.Bench(root),
                            "googlenet-block90.tiny-ahead", SEED, 0.2, True,
                            CPU, clock=lambda: 1.0, **kw)


def test_sound_run_sent_ahead_is_correct(bench_root):
    r = _run(_ahead_root(bench_root))
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] >= 2


def test_control_sent_ahead_is_not_correct(bench_root):
    r = _run(_ahead_root(bench_root), make_system=lambda cfg, t, p, d:
             ReferenceSystem(cfg, t, p, d, "float8_e4m3fn"))
    assert not r["correct"], r["checks"]
