"""Op-level profile of a whole sparse forward (port of
``scripts/exp_opprofile_r5.py`` and ``exp_gln_profile_r5.py``, with
``exp_gln_hlo_r5.py``'s question, which graph site a hot op is, answered by
layer spans).

ResNet-50 b32 packed or GoogLeNet b16 unpacked (``--net``), built as the
scripts build them (``common.sparse_net``: 90% in 128x128 blocks, fused,
aligned, autotuned), run under ``autotune.net_scope``. After a warm-up on
the 4 inputs, ``torch.profiler`` (CPU and CUDA activities) records
``--iters`` forwards, after one more it keeps no events of, in two forms:

* ``graph``: ``Net.inference_fn(cuda_graph=True)`` replays, the
  counterpart of the one jitted module;
* ``eager``: ``Net.forward`` with the program's tracing on
  (``utils/trace``), which puts each layer's call in a ``cet:layer:<name>``
  span. Every kernel is attributed to the layer whose span ran it; a
  replay has no spans, so the graph form's kernels take the layers the
  eager form found for their names.

Output: one ``opprofile`` row per form, ``module_total_ms_per_iter`` (the
device time of its kernels and copies per forward) beside ``graph_ms``
(``device_time`` of the whole forward as CUDA-graph replays), the
kernels' and the copies' time per forward, the graph form's
``non_kernel_share`` (1 - kernel time / ``graph_ms``: copies and the gaps
between kernels), and each hand kernel's calls per forward
beside the launch counter's; then the top ``--top`` kernels (40 for
ResNet-50, 60 for GoogLeNet) by total time as ``opprofile_kernel`` rows:
us per forward, share, name, the hand kernel it is (by its Rows policy:
``sconv_fused``, ``sconv_gc``, ``bsc_spmm``) and its layers. Where the
profiler sees no kernel inside the graph replays (CUPTI and the driver
decide), the graph row says so (``kernels_seen: false``) and has no kernel
rows: no per-kernel number is made up for it. On the CPU the table holds
the CPU ops' self times instead of device kernels.

    python -m caffe_escoin_tpu_torch.experiments.opprofile --net resnet50
    python -m caffe_escoin_tpu_torch.experiments.opprofile --net googlenet
"""

from __future__ import annotations

import bisect
import collections
import sys

import torch

from caffe_escoin_tpu_torch.engine import autotune
from caffe_escoin_tpu_torch.experiments import common
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_fused, sconv_gc
from caffe_escoin_tpu_torch.utils import trace
from caffe_escoin_tpu_torch.utils.benchmark import device_time

NETS = {  # net -> (batch, packed, top kernels printed), as the scripts ran
    "resnet50": (32, True, 40),
    "googlenet": (16, False, 60),
}
ITERS = 12
LAYER_SPAN = trace.PREFIX + trace.LAYER
KERNEL_MODULES = {"sconv_fused": sconv_fused, "sconv_gc": sconv_gc,
                  "bsc_spmm": bsc_spmm}
_COPY = ("Memcpy", "Memset")
_STEP = "ProfilerStep"
# the three hand kernels, by the Rows policy their sconv_pipe_kernel
# instance is named after in a trace
KERNEL_OF_ROWS = {"ConvRows": "sconv_fused", "SlabRows": "sconv_gc",
                  "DenseRows": "bsc_spmm"}


def kernel_of(name: str) -> str:
    """The hand kernel a trace's kernel name is an instance of (by its Rows
    policy), or the name itself."""
    for rows, kernel in KERNEL_OF_ROWS.items():
        if rows in name:
            return kernel
    return name


def aggregate(events, cuda: bool):
    """(records, copy_us): ``records`` maps a kernel name (an op name on
    the CPU) to its total us, its calls and its us by layer; ``copy_us``
    is the device's memcpy and memset time. An op's layer is the
    ``cet:layer:`` span that holds its start: on the card the span's
    device-side range (the profiler's projection of a ``record_function``
    onto the GPU timeline), since the hand kernels, launched through
    ctypes, have no CPU op to be correlated with; on the CPU the span
    itself. The program's spans (``cet:``) and the profiler's step marks
    (``ProfilerStep*``) are no ops."""
    kind = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    mine = [e for e in events if e.device_type == kind]
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len(LAYER_SPAN):]) for e in mine
                   if e.name.startswith(LAYER_SPAN))
    starts = [sp[0] for sp in spans]
    totals = collections.defaultdict(lambda: {"us": 0.0, "calls": 0})
    layers = collections.defaultdict(collections.Counter)
    copy_us = 0.0
    for e in mine:
        if e.name.startswith((trace.PREFIX, _STEP)):
            continue
        if cuda:
            us = e.time_range.elapsed_us()
            if e.name.startswith(_COPY):
                copy_us += us
                continue
        else:
            us = e.self_cpu_time_total
            if us <= 0:
                continue
        totals[e.name]["us"] += us
        totals[e.name]["calls"] += 1
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= spans[i][1]:
            layers[e.name][spans[i][2]] += us
    return {name: {**t, "layers": layers.get(name, {})}
            for name, t in totals.items()}, copy_us


def kernel_rows(records, iters: int, top: int):
    """The ``top`` records by total time: us per forward, share of all
    records' time, calls per forward, the hand kernel, the layers (most
    time first)."""
    total = sum(r["us"] for r in records.values()) or 1.0
    ranked = sorted(records.items(), key=lambda kv: -kv[1]["us"])[:top]
    rows = []
    for rank, (name, r) in enumerate(ranked, 1):
        by_layer = sorted(((l, us) for l, us in r["layers"].items()),
                          key=lambda lu: -lu[1])
        rows.append({
            "rank": rank, "us_per_iter": round(r["us"] / iters, 3),
            "share": round(r["us"] / total, 5),
            "calls_per_iter": r["calls"] / iters,
            "kernel": kernel_of(name), "name": name[:200],
            "layer": by_layer[0][0] if by_layer else None,
            "n_layers": len(by_layer)})
    return rows


def hand_calls(records, iters: int):
    """Calls per forward of each hand kernel in ``records``."""
    calls = collections.Counter()
    for name, r in records.items():
        kernel = kernel_of(name)
        if kernel in KERNEL_MODULES:
            calls[kernel] += r["calls"]
    return {k: calls[k] / iters for k in KERNEL_MODULES}


def _profile(fn, iters, cuda):
    """The profiler's events of ``fn(0)`` to ``fn(iters - 1)``, and the
    hand kernels' launches over those calls. A warm-up call comes first,
    which the profiler runs but keeps no events of: the first kernels of
    a window can go unrecorded (on an H100, in a process that had
    profiled before: the first forward's kernels up to its first
    ``sconv_fused``), so the warm-up takes that loss."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=1)) as prof:
        fn(iters)
        if cuda:
            torch.cuda.synchronize()
        prof.step()
        before = {k: m.launches for k, m in KERNEL_MODULES.items()}
        for i in range(iters):
            fn(i)
        if cuda:
            torch.cuda.synchronize()
        launched = {k: m.launches - before[k]
                    for k, m in KERNEL_MODULES.items()}
    return prof.events(), launched


def run(device, emit, *, net_name="resnet50", batch=None, iters=ITERS,
        top=None):
    """The two forms' rows and their kernel tables; returns
    ``{form: (row, kernel rows)}``."""
    d_batch, pack, d_top = NETS.get(net_name, (1, False, 40))
    batch = d_batch if batch is None else batch
    top = d_top if top is None else top
    cuda = device.type == "cuda"
    s = common.sparse_net(net_name, batch, device, pack=pack)
    net, aligned, xs = s.net, s.aligned, s.xs
    out = {}
    with autotune.net_scope(net_name):
        graph_fn = net.inference_fn(aligned, cuda_graph=True)
        for x in xs:  # measures each key, then captures
            graph_fn({"data": x})
        eager_fn = net.inference_fn(aligned)
        graph_ms = device_time(
            lambda y: common.first(eager_fn({"data": y})), xs[0],
            iters=20, arg_sets=[(x,) for x in xs]) * 1e3
        forms = {  # eager first: the graph form's layers are its
            "eager": lambda i: net.forward(aligned,
                                           {"data": xs[i % len(xs)]}),
            "graph": lambda i: graph_fn({"data": xs[i % len(xs)]}),
        }
        by_name = {}
        for form, fn in forms.items():
            if form == "eager":
                trace.enable()
            try:
                with torch.inference_mode():
                    events, launched = _profile(fn, iters, cuda)
            finally:
                trace.disable()
            launched = {k: n / iters for k, n in launched.items()}
            records, copy_us = aggregate(events, cuda)
            for name, r in records.items():
                # a replay has no spans: a kernel's layers are the ones
                # the eager form found for its name
                if not r["layers"] and name in by_name:
                    r["layers"] = by_name[name]
            by_name = {name: r["layers"] for name, r in records.items()}
            kernel_us = sum(r["us"] for r in records.values())
            seen = bool(records)
            module_ms = (kernel_us + copy_us) / iters / 1e3
            row = emit(kind="opprofile", net=net_name, batch=batch,
                       packed=bool(getattr(net, "packed_blobs", None)),
                       form=form, iters=iters, kernels_seen=seen,
                       module_total_ms_per_iter=round(module_ms, 4),
                       graph_ms=round(graph_ms, 4),
                       kernel_ms_per_iter=round(kernel_us / iters / 1e3, 4),
                       copy_ms_per_iter=round(copy_us / iters / 1e3, 4),
                       non_kernel_share=(round(1 - kernel_us / iters / 1e3
                                               / graph_ms, 4)
                                         if cuda and seen and form == "graph"
                                         else None),
                       hand_calls_per_iter=hand_calls(records, iters),
                       launches_per_iter=launched,
                       distinct_kernels=len(records))
            krows = [emit(kind="opprofile_kernel", net=net_name, form=form,
                          **k) for k in kernel_rows(records, iters, top)]
            out[form] = (row, krows)
    return out


def main(argv=None) -> int:
    ap = common.parser("opprofile", __doc__)
    ap.add_argument("--net", default="resnet50", choices=sorted(NETS),
                    help="resnet50: b32 packed, 40 kernels listed; "
                         "googlenet: b16 unpacked, 60")
    args = ap.parse_args(argv)
    device = common.device_of(args.platform)
    if device is None:
        return 2
    with common.env_defaults():
        run(device, common.Rows(args.out, device), net_name=args.net)
    return 0


if __name__ == "__main__":
    sys.exit(main())
