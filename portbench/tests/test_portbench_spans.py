"""The program's spans in a traced run (``program_trace.py``).

On the CPU: the clock-offset interval and the idle charging on synthetic
events; the existing stretch and layer-stepped forwards hold no ``cet:``
event (the program's tracing is off there); the readings of a tiny cell
through the program's plain routes; nothing read for the reference in
the program's place; the set-up reader.

On the card (``cuda``): each capture counts the hand kernels a replay
launches, 51 ``sconv_fused`` and 1 ``bsc_spmm`` for ResNet-50 and 47 and
1 for GoogLeNet; the device time charged per layer by the program's
``cet:layer:`` spans equals what the ``pb:layer:`` hook's spans give.
"""

import sys
import types

import pytest
import torch

from portbench import harness, program_trace, traced, weights
from portbench.system import PortSystem, ReferenceSystem
from portbench.tests.conftest import ROOT

CUDA = torch.autograd.DeviceType.CUDA
CPU_EV = torch.autograd.DeviceType.CPU
CPU = torch.device("cpu")
SEED = 2 ** 31 + 29
CELLS = ["googlenet-block90.tiny", "resnet50-block90.tiny"]


def ev(name, start, end, device=CUDA):
    return types.SimpleNamespace(
        name=name, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=end))


def queries(device_shift=0.0):
    """Two queries: host spans, their device-side projections (each
    operation on the innermost span that launched it) and the operations,
    the device's clock ``device_shift`` us ahead."""
    d = device_shift
    return [
        ev(traced.QUERY, 0, 100, CPU_EV), ev(traced.ISSUE, 0, 30, CPU_EV),
        ev("cet:entry", 2, 28, CPU_EV), ev("cet:entry:copy_in", 4, 8, CPU_EV),
        ev("cet:entry:replay", 10, 26, CPU_EV),
        ev(traced.TO_HOST, 30, 100, CPU_EV),
        ev(traced.QUERY, 110, 200, CPU_EV), ev(traced.ISSUE, 110, 140, CPU_EV),
        ev("cet:entry", 112, 138, CPU_EV),
        ev("cet:entry:copy_in", 114, 118, CPU_EV),
        ev("cet:entry:replay", 120, 136, CPU_EV),
        ev(traced.TO_HOST, 140, 200, CPU_EV),
        ev("cet:entry:copy_in", 6 + d, 8 + d),
        ev("cet:entry:replay", 12 + d, 80 + d),
        ev(traced.TO_HOST, 85 + d, 95 + d),
        ev("cet:entry:copy_in", 116 + d, 118 + d),
        ev("cet:entry:replay", 122 + d, 180 + d),
        ev(traced.TO_HOST, 182 + d, 190 + d),
        ev("copy_in", 6 + d, 8 + d), ev("k", 12 + d, 80 + d),
        ev("Memcpy DtoH", 85 + d, 95 + d), ev("copy_in", 116 + d, 118 + d),
        ev("k", 122 + d, 180 + d), ev("Memcpy DtoH", 182 + d, 190 + d),
    ]


def test_offsets_from_causality():
    ops, host, dev = program_trace.split(queries())
    assert [o.name for o in ops] == ["copy_in", "k", "Memcpy DtoH",
                                     "copy_in", "k", "Memcpy DtoH"]
    # delta <= min(6 - 4, 12 - 10, 85 - 30) and >= 95 - 100 in the first
    # query; <= min(116 - 114, 122 - 120, 182 - 140) and >= 190 - 200 in
    # the second
    assert program_trace.offsets(host, dev) == [(-5, 2), (-10, 2)]
    ops, host, dev = program_trace.split(queries(1000.0))
    assert program_trace.offsets(host, dev) == [(995, 1002), (990, 1002)]
    no_copy = [s for s in dev if s.name != traced.TO_HOST]
    assert program_trace.offsets(host, no_copy) is None


def test_flatten_names_the_innermost_span():
    S = traced.Span
    got = program_trace.flatten([S("a", 0, 10), S("b", 2, 4), S("c", 4, 6),
                                 S("d", 12, 14)])
    assert got == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a"),
                   (12, 14, "d")]


def test_idle_charged_by_overlap_to_the_innermost_span():
    r = program_trace.read_profiled(queries())
    assert r["offset_us"] == [-5, 2] and r["offset_zero_inside"]
    assert r["queries_shifted"] == 0
    idle = {k: pytest.approx(v * 1e6) for k, v in r["idle_by_span"].items()}
    # gaps: 0-6 (outside 0-2, entry 2-4, copy_in 4-6); 8-12 (entry 8-10,
    # replay 10-12); 80-85 (to_host); 95-116 (to_host 95-100, outside
    # 100-112, entry 112-114, copy_in 114-116); 118-122 (entry 118-120,
    # replay 120-122); 180-182, 190-200 (to_host)
    assert idle == {"outside": 2 + 12, "entry": 2 + 2 + 2 + 2,
                    "entry:copy_in": 2 + 2, "entry:replay": 2 + 2,
                    "to_host": 5 + 5 + 2 + 10}
    assert r["idle_s"] == pytest.approx(52e-6)
    assert r["idle_in_entry_pct"] == pytest.approx(100 * 16 / 52)


def test_each_query_on_its_own_offset():
    """The device's clock 1000 us ahead: each query's device times are
    shifted by its bounds' midpoint (998.5, then 996 us), and the windows
    meet on the device's clock at the second query's shifted start."""
    r = program_trace.read_profiled(queries(1000.0))
    assert r["offset_us"] == [995, 1002] and not r["offset_zero_inside"]
    assert r["queries_shifted"] == 2 and r["shift_us"] == [996, 998.5]
    idle = {k: pytest.approx(v * 1e6) for k, v in r["idle_by_span"].items()}
    # first query, device 998.5-1106 on the host 0-107.5: gaps 0-7.5,
    # 9.5-13.5, 81.5-86.5, 96.5-107.5; second, 1106-1196 on the host
    # 110-200: gaps 110-120, 122-126, 184-186, 194-200
    assert idle == {"outside": 2 + 7.5 + 2, "entry": 2 + 0.5 + 2 + 2,
                    "entry:copy_in": 3.5 + 4, "entry:replay": 3.5 + 4,
                    "to_host": 5 + 3.5 + 2 + 6}
    assert r["idle_s"] == pytest.approx(49.5e-6)


def test_no_device_operations_nothing_to_read():
    assert program_trace.read_profiled([]) is None
    host_only = [e for e in queries() if e.device_type == CPU_EV]
    assert program_trace.read_profiled(host_only) is None


def test_charge_layers_by_program_spans():
    events = [ev("cet:layer:conv1", 0, 10), ev("cet:layer:pool1", 10, 30),
              ev("pb:layer:conv1", 0, 10), ev("cet:entry", 0, 40),
              ev("k_a", 1, 6), ev("k_b", 12, 20), ev("k_c", 50, 51)]
    assert program_trace.charge_layers(events, 2) == {"conv1": 2.5,
                                                      "pool1": 4.0}


def _run(root, cell, trace_on=True, **kw):
    return harness.run_cell(harness.Bench(root), cell, SEED, 0.1, trace_on,
                            CPU, clock=lambda: 1.0, **kw)


def test_existing_readings_hold_no_program_event(bench_root, monkeypatch):
    """The stretch and the layer-stepped forwards run with the program's
    tracing off: no ``cet:`` event, and nothing traced per query."""
    from caffe_escoin_tpu_torch.utils import trace

    seen = []
    for name in ("read_stretch", "charge_layers"):
        real = getattr(traced, name)

        def spy(events, *a, _real=real):
            seen.append([e.name for e in events])
            return _real(events, *a)

        monkeypatch.setattr(traced, name, spy)
    before = trace.snapshot()
    r = _run(bench_root, CELLS[0])
    assert r["correct"] and len(seen) == 2
    assert all(names for names in seen)
    assert not [n for names in seen for n in names
                if n.startswith(program_trace.PROGRAM)]
    after = trace.snapshot()
    assert {k for k in after["spans"] if not k.startswith("setup:")} == \
        {k for k in before["spans"] if not k.startswith("setup:")}
    assert not trace.enabled()


@pytest.mark.parametrize("cell", CELLS)
def test_readings_of_a_tiny_cell(bench_root, monkeypatch, cell):
    readings = {}
    original = harness._traced

    def traced_then_program(run, system, pool, n0, device):
        out = original(run, system, pool, n0, device)
        readings.update(program_trace.read(run, system, pool, n0, device))
        return out

    monkeypatch.setattr(harness, "_traced", traced_then_program)
    r = _run(bench_root, cell)
    assert r["correct"]
    n = harness.Bench(bench_root).traffic("tiny-b2")["trace_queries"]
    # CPU inputs run eagerly: nothing is captured
    assert {"setup:fuse", "setup:align", "setup:to_device"} == \
        set(readings["setup"])
    u = readings["unprofiled"]
    assert u["entry_span_ms"] > 0 and u["latency_ms_p50_on"] > 0
    # CPU inputs run eagerly: every traced query is an eager call
    assert u["queries"] == 2 * n
    assert u["counters"] == {"entry.eager_calls": 2 * n}
    assert set(u["phases_ms"]) == {"entry"}
    assert readings["profiled"] is None  # no device operations here
    from caffe_escoin_tpu_torch.utils import trace

    assert not trace.enabled()


def test_nothing_read_for_the_reference(bench_root, monkeypatch):
    got = []
    original = harness._traced

    def traced_then_program(run, system, pool, n0, device):
        out = original(run, system, pool, n0, device)
        got.append(program_trace.read(run, system, pool, n0, device))
        return out

    monkeypatch.setattr(harness, "_traced", traced_then_program)
    _run(bench_root, CELLS[0], make_system=lambda cfg, t, p, d:
         ReferenceSystem(cfg, t, p, d, "bfloat16"))
    assert got == [None]


def test_setup_reader(bench_root, monkeypatch):
    from caffe_escoin_tpu_torch.utils import trace

    _run(bench_root, CELLS[0], trace_on=False)
    reader = harness.Bench(ROOT).reader("program_setup_s")
    spans = trace.snapshot()["spans"]
    builds = sum(spans[k]["self_s"] for k in ("setup:kernel_build",
                                              "setup:native_build")
                 if k in spans)
    want = sum(s["self_s"] for k, s in spans.items()
               if k.startswith("setup:")) - builds
    assert reader(None) == pytest.approx(want) and want > 0
    monkeypatch.delitem(sys.modules, program_trace.TRACE_MODULE)
    assert reader(None) is None


# ---- on the card -----------------------------------------------------------

def _card_system(card, config):
    bench = harness.Bench(ROOT)
    cfg = bench.config(config)
    table, params, _ = weights.make_net(cfg, bench.reference(
        cfg["reference"]), SEED, card)
    x = weights.images(2, tuple(cfg["input_hwc"]),
                       weights.generator(SEED, weights.POOL, card), card)
    return PortSystem(cfg, table, params, card), x


@pytest.mark.cuda
@pytest.mark.parametrize("config,fused", [("resnet50-block90", 51),
                                          ("googlenet-block90", 47)])
def test_capture_launches(card, config, fused):
    from caffe_escoin_tpu_torch.utils import trace

    system, x = _card_system(card, config)
    before = trace.snapshot()["counters"]
    system.query(x)
    after = trace.snapshot()["counters"]
    got = {k: after.get(f"capture.launches.{k}", 0)
           - before.get(f"capture.launches.{k}", 0) for k in trace.KERNELS}
    assert got == {"sconv_fused": fused, "sconv_gc": 0, "bsc_spmm": 1}
    assert after["entry.captures"] - before.get("entry.captures", 0) == 1
    system.close()


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["resnet50-block90", "googlenet-block90"])
def test_layer_charges_match_the_hook(card, config):
    """Eager forwards in turn with the hook's spans (tracing off) and with
    the program's (tracing on, no hook), in one profile: the device time a
    forward that the program's spans charge to each layer
    (``program_trace.charge_layers``) is the hook's (``traced.
    charge_layers``, shown the events it sees today) within 1%, or 1 us
    for the smallest layers. The profiler projects an operation onto the
    innermost span that launched it only, so the two kinds of span cannot
    share a forward."""
    from caffe_escoin_tpu_torch.utils import trace

    forwards = 5
    system, x = _card_system(card, config)
    spans = traced.LayerSpans()

    def hooked():
        system.eager_forward(x, spans.hook)
        spans.close()

    def program():
        trace.enable()
        try:
            system.eager_forward(x)
        finally:
            trace.disable()

    hooked()
    program()
    torch.cuda.synchronize(card)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(forwards):
            hooked()
            program()
        torch.cuda.synchronize(card)
    events = prof.events()
    hook = traced.charge_layers(
        [e for e in events if not e.name.startswith(program_trace.PROGRAM)],
        forwards)
    mine = program_trace.charge_layers(events, forwards)
    assert set(hook) == set(mine) and len(mine) > 20
    worst = max(abs(mine[n] - us) / us for n, us in hook.items())
    print(f"{config}: {len(hook)} layers, {sum(hook.values()):.1f} / "
          f"{sum(mine.values()):.1f} us a forward, worst {worst:.4f}")
    for name, us in hook.items():
        assert mine[name] == pytest.approx(us, rel=0.01, abs=1.0), name
    system.close()
