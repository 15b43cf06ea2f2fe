"""The program's spans and counters (``caffe_escoin_tpu_torch/utils/trace``).

On the CPU, on LeNet:

* with tracing off, a ``Net.forward`` and an ``inference_fn`` call under
  ``torch.profiler`` hold no ``cet:`` event and make no
  ``record_function`` at all;
* with tracing on, each layer is one ``cet:layer:<name>`` event, in the
  net's order, and one ``layer:<name>`` span in the aggregates;
* the entry's counters and spans count the calls, self time is total time
  less the spans inside, and ``reset`` clears them;
* the set-up spans record with tracing off.

On the card (``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_trace.py``): a graph forward's capture counts each hand
kernel's launches in the captured forward, and traced calls replay the
captured graph, with the entry's phases.
"""

import time

import pytest
import torch

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu_torch.models import ZOO
from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
from caffe_escoin_tpu_torch.utils import trace
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def lenet(device=CPU, batch=2):
    """LeNet pruned at 90% in 16x16 blocks, fused and aligned on the
    kernel routes; (net, aligned params, input)."""
    make_specs, shapes = ZOO["lenet"]
    policy = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                             block_shape=(16, 16), use_xla_sparse=False)
    net = Net(make_specs(), policy=policy, phase="test")
    shape = (batch,) + tuple(shapes["data"][1:])
    params = net.init(torch.Generator().manual_seed(0), {"data": shape})
    conv2 = params["conv2"]["w"].numpy()
    params["conv2"] = dict(params["conv2"], w=torch.from_numpy(
        prune_conv_weight(conv2, 0.9, (16, 16))))
    net, params = fuse_inference(net, params)
    aligned = params_to(net.weight_align(params), device)
    net.state0 = params_to(net.state0, device)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    return net, aligned, x.to(device)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_off_no_event_and_no_record_function(monkeypatch):
    net, aligned, x = lenet()
    fn = net.inference_fn(aligned, cuda_graph=True)

    def refused(*a, **k):
        raise AssertionError("a record_function with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    names = _profiled(lambda: (net.forward(aligned, {"data": x}),
                               fn({"data": x})))
    assert names and not [n for n in names if n.startswith(trace.PREFIX)]
    spans = trace.snapshot()["spans"]
    assert not [n for n in spans if not n.startswith("setup:")]


def test_on_one_layer_span_per_layer_in_order():
    net, aligned, x = lenet()
    trace.enable()
    with torch.inference_mode():
        names = _profiled(lambda: net.forward(aligned, {"data": x}))
    layers = [layer.spec.name for layer in net.layers]
    prefix = trace.PREFIX + trace.LAYER
    assert [n[len(prefix):] for n in names if n.startswith(prefix)] == layers
    spans = trace.snapshot()["spans"]
    for name in layers:
        assert spans[trace.LAYER + name]["count"] == 1


def test_on_without_a_profile_makes_no_record_function(monkeypatch):
    net, aligned, x = lenet()

    def refused(*a, **k):
        raise AssertionError("a record_function with no profile recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    trace.enable()
    with torch.inference_mode():
        net.forward(aligned, {"data": x})
    assert trace.snapshot()["spans"]["layer:conv1"]["count"] == 1


def test_entry_counters_spans_and_reset():
    net, aligned, x = lenet()
    graph_fn = net.inference_fn(aligned, cuda_graph=True)
    eager_fn = net.inference_fn(aligned)
    graph_fn({"data": x})
    eager_fn({"data": x})
    assert "entry.eager_calls" not in trace.snapshot()["counters"]
    trace.enable()
    for _ in range(3):
        graph_fn({"data": x})  # CPU inputs: eager
    eager_fn({"data": x})
    snap = trace.snapshot()
    assert snap["counters"]["entry.eager_calls"] == 4
    assert snap["spans"]["entry"]["count"] == 4
    assert snap["spans"][trace.LAYER + "conv1"]["count"] == 4
    assert set(snap["kernels"]) == set(trace.KERNELS + trace.OP_KERNELS)
    trace.reset()
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}


def test_self_time_is_total_less_inner_spans():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            time.sleep(0.02)
        with trace.span("inner"):
            pass
    spans = trace.snapshot()["spans"]
    outer, inner = spans["outer"], spans["inner"]
    assert inner["count"] == 2 and inner["max_s"] >= 0.02
    assert outer["total_s"] >= inner["total_s"] >= 0.02
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    trace.count("n", 3)
    trace.count("n")
    assert trace.snapshot()["counters"]["n"] == 4
    trace.disable()
    with trace.span("outer"):
        trace.count("n")
    assert trace.snapshot()["spans"]["outer"]["count"] == 1
    assert trace.snapshot()["counters"]["n"] == 4


def test_setup_spans_record_with_tracing_off():
    assert not trace.enabled()
    net, aligned, x = lenet()
    spans = trace.snapshot()["spans"]
    assert spans["setup:fuse"]["count"] == 1
    assert spans["setup:align"]["count"] == 1
    assert spans["setup:to_device"]["count"] == 2  # params, then state
    assert all(s["total_s"] >= s["self_s"] >= 0 for s in spans.values())
    trace.count("c", always=True)
    assert trace.snapshot()["counters"] == {"c": 1}


def lenet_autotuned(tmp_path, device=CPU, batch=2, autotune_on=True):
    """LeNet with conv2 and ip1 pruned at 90% in 16x16 blocks, fused and
    aligned on the XBSP branch, autotuned with a cache file of its own in
    ``tmp_path``; (net, aligned params, input, pruned layer names)."""
    from caffe_escoin_tpu_torch.engine import autotune

    autotune.clear()
    make_specs, shapes = ZOO["lenet"]
    policy = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                             block_shape=(16, 16), autotune=autotune_on,
                             autotune_cache=str(tmp_path / "arms.json"))
    net = Net(make_specs(), policy=policy, phase="test")
    shape = (batch,) + tuple(shapes["data"][1:])
    params = net.init(torch.Generator().manual_seed(0), {"data": shape})
    for name in ("conv2", "ip1"):
        w = params[name]["w"].numpy()
        w4 = w if w.ndim == 4 else w[None, None]
        pruned = prune_conv_weight(w4, 0.9, (16, 16)).reshape(w.shape)
        params[name] = dict(params[name], w=torch.from_numpy(pruned))
    net, params = fuse_inference(net, params)
    aligned = params_to(net.weight_align(params), device)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    return net, aligned, x.to(device), ("conv2", "ip1")


def _autotune_counters():
    return {k: n for k, n in trace.snapshot()["counters"].items()
            if k.startswith("autotune.")}


def test_autotune_spans_and_counters_record_with_tracing_off(tmp_path):
    """Each key autotune measures is one ``setup:autotune`` span and one
    ``autotune.measured.conv`` or ``.fc``, tracing off; a second forward
    measures nothing; the picks of a forward counted by ``counting_picks``
    sum to the pruned layers, and an enclosing ``record_keys`` sees them
    too."""
    from caffe_escoin_tpu_torch.engine import autotune

    assert not trace.enabled()
    net, aligned, x, pruned = lenet_autotuned(tmp_path)
    with torch.inference_mode():
        net.forward(aligned, {"data": x})
        snap = trace.snapshot()
        assert snap["spans"]["setup:autotune"]["count"] == 2
        assert _autotune_counters() == {"autotune.measured.conv": 1,
                                        "autotune.measured.fc": 1}
        with autotune.record_keys() as outer:
            with autotune.counting_picks() as picks:
                net.forward(aligned, {"data": x})
    assert trace.snapshot()["spans"]["setup:autotune"]["count"] == 2
    got = _autotune_counters()
    assert got.pop("autotune.measured.conv") == 1
    assert got.pop("autotune.measured.fc") == 1
    assert all(k.startswith("autotune.pick.") for k in got)
    assert sum(got.values()) == len(pruned) == len(picks)
    assert outer == picks
    for _, arm in picks:
        assert got[f"autotune.pick.{arm}"] >= 1
    # the routes name the picks ("bsc_spmm" is the fc route "spmm")
    routes = net.routes(aligned, {"data": tuple(x.shape)})
    assert sorted(routes[n] for n in pruned) == sorted(
        {"bsc_spmm": "spmm"}.get(arm, arm) for _, arm in picks)
    autotune.clear()


def test_autotune_off_records_nothing(tmp_path):
    from caffe_escoin_tpu_torch.engine import autotune

    net, aligned, x, _ = lenet_autotuned(tmp_path, autotune_on=False)
    with torch.inference_mode(), autotune.counting_picks() as picks:
        net.forward(aligned, {"data": x})
    assert picks == [] and _autotune_counters() == {}
    assert "setup:autotune" not in trace.snapshot()["spans"]


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_capture_counts_launches_and_traced_calls_replay(dev):
    net, aligned, x = lenet(dev, batch=8)
    aligned = params_to(aligned, dev, torch.bfloat16)
    before = trace.kernel_counts()
    with torch.inference_mode():
        want = net.forward(aligned, {"data": x})
    eager = {k: n["launches"] - before[k]["launches"]
             for k, n in trace.kernel_counts().items()}
    assert sum(eager.values()) > 0
    fn = net.inference_fn(aligned, cuda_graph=True)
    first = {k: v.clone() for k, v in fn({"data": x}).items()}
    snap = trace.snapshot()
    assert snap["counters"]["entry.captures"] == 1
    assert snap["spans"]["setup:first_call"]["count"] == 1
    assert snap["spans"]["setup:capture"]["count"] == 1
    for k, n in eager.items():
        assert snap["counters"][f"capture.launches.{k}"] == n
    trace.enable()
    for _ in range(3):
        got = fn({"data": x})
    torch.cuda.synchronize(dev)
    snap = trace.snapshot()
    assert snap["counters"]["entry.captures"] == 1  # same signature
    assert snap["counters"]["entry.replays"] == 3
    for name in ("entry", "entry:signature", "entry:copy_in",
                 "entry:replay"):
        assert snap["spans"][name]["count"] == 3
    for k in want:
        assert torch.equal(got[k], first[k])


@pytest.mark.cuda
def test_capture_counts_the_autotuned_picks(dev, tmp_path):
    """A capture counts one ``autotune.pick.<arm>`` per pruned layer of the
    captured forward, as the layers' routes name them; the measuring is
    inside the first call, never in the capture."""
    net, aligned, x, pruned = lenet_autotuned(tmp_path, dev, batch=8)
    aligned = params_to(aligned, dev, torch.bfloat16)
    fn = net.inference_fn(aligned, cuda_graph=True)
    fn({"data": x})
    fn({"data": x})
    snap = trace.snapshot()
    assert snap["counters"]["entry.captures"] == 1
    assert snap["counters"]["autotune.measured.conv"] == 1
    assert snap["counters"]["autotune.measured.fc"] == 1
    picks = {k[len("autotune.pick."):]: n for k, n in snap["counters"].items()
             if k.startswith("autotune.pick.")}
    assert sum(picks.values()) == len(pruned)
    assert snap["spans"]["setup:autotune"]["count"] == 2
    assert (snap["spans"]["setup:first_call"]["total_s"]
            >= snap["spans"]["setup:autotune"]["total_s"])
