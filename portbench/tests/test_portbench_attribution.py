"""Span attribution and the stretch's arithmetic on synthetic events."""

import types

import pytest

import torch

from portbench import traced

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CUDA):
    return types.SimpleNamespace(
        name=name, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_charge_layers_by_start_of_operation():
    events = [
        ev(traced.LAYER + "conv1", 0, 10), ev(traced.LAYER + "pool1", 10, 30),
        ev(traced.LAYER + "conv1", 0, 1, CPU),
        ev("k_a", 1, 6), ev("k_b", 8, 12),      # starts inside conv1
        ev("Memcpy DtoD", 12, 14),              # copies count too
        ev("k_c", 29, 40),                      # starts inside pool1
        ev("k_d", 50, 51),                      # in no span
    ]
    got = traced.charge_layers(events, forwards=2)
    assert got == {"conv1": (5 + 4) / 2, "pool1": (2 + 11) / 2}


def test_union_busy_and_gaps():
    ops = [traced.Op("a", 0, 4), traced.Op("b", 2, 6), traced.Op("c", 8, 9)]
    assert traced.union([(o.start, o.end) for o in ops]) == [(0, 6), (8, 9)]
    assert traced.busy_us(ops, 0, 10) == 7
    assert traced.gaps(ops, 0, 10) == [(6, 8), (9, 10)]


def test_read_stretch():
    events = [
        ev(traced.QUERY, 0, 100, CPU), ev(traced.ISSUE, 0, 20, CPU),
        ev(traced.TO_HOST, 20, 100, CPU),
        ev(traced.QUERY, 110, 200, CPU), ev(traced.ISSUE, 110, 130, CPU),
        ev(traced.TO_HOST, 130, 200, CPU),
        # the device-side projections, on the device's own clock (here 1000
        # us off the host's: no host time is compared with a device time)
        ev(traced.ISSUE, 1010, 1080), ev(traced.TO_HOST, 1085, 1090),
        ev(traced.ISSUE, 1120, 1190), ev(traced.TO_HOST, 1192, 1195),
        ev("copy_in", 1010, 1015), ev("sconv_pipe_kernel<ConvRows>", 1015, 1040),
        ev("sconv_pipe_kernel<ConvRows>", 1050, 1080),
        ev("Memcpy DtoH", 1085, 1090),
        ev("copy_in", 1120, 1125), ev("sconv_pipe_kernel<ConvRows>", 1125, 1190),
        ev("Memcpy DtoH", 1192, 1195),
    ]
    s = traced.read_stretch(events)
    assert s.queries == 2 and s.ops_per_query == 3.5
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx((5 + 25 + 30 + 5 + 5 + 65 + 3) * 1e-6)
    # latency minus the span from the issue's first operation to the end of
    # the logits' copy: 100 - 80 and 90 - 75
    assert s.host_ms == pytest.approx([20e-3, 15e-3])
    idle = dict(s.idle_by_place)
    assert idle["replay"] == pytest.approx(10e-6)  # 1040-1050, in the replay
    # 1080-1085, 1090-1120, 1190-1192, and the window's 200 - 185 - 47
    # outside the operations
    assert idle["turnaround"] == pytest.approx((5 + 30 + 2 + 200 - 138 - 47)
                                               * 1e-6)
    assert traced.hand_kernels(events)["sconv_fused"] == 3


def test_nothing_to_read():
    assert traced.read_stretch([]) is None
    assert traced.charge_layers([], forwards=1) == {}


def test_idle_and_mfu_read_the_untraced_window():
    """Idle, one query in flight: 1 - busy a query in the profiled stretch
    / the measured window's time a query; queries sent ahead: 1 - busy /
    the stretch's length; mfu: live FLOPs over the measured window."""
    from types import SimpleNamespace

    from portbench import harness
    from portbench.tests.conftest import ROOT

    bench = harness.Bench(ROOT)
    stretch = SimpleNamespace(queries=200, busy_s=0.3, window_s=0.5)
    run = SimpleNamespace(stretch=stretch, queries=5000, window_s=10.0,
                          traffic={}, peak={"bf16_flop_s": 1e15},
                          work={"a": {"flops": 1e11}, "b": {"flops": 1e11}})
    for name in ("device_idle_pct.offline", "device_idle_pct.stream"):
        assert bench.reader(name)(run) == pytest.approx(
            100 * (1 - 0.0015 / 0.002))
    assert bench.reader("step_mfu_pct.offline")(run) == pytest.approx(
        100 * 2e11 * 500 / 1e15)
    run.traffic = {"ahead_seconds": 4.0}
    assert bench.reader("device_idle_pct.offline")(run) == pytest.approx(
        100 * (1 - 0.3 / 0.5))
    run.stretch = None
    assert bench.reader("device_idle_pct.stream")(run) is None
