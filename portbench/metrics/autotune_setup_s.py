"""The program's autotuning in set-up: the self time of its
``setup:autotune`` spans (``caffe_escoin_tpu_torch/utils/trace``; one
around each measurement of a layer's arms, inside the first call), read
as ``program_setup_s`` reads its spans, so the kernels' build and load,
which a first measurement may hold, are left out. Nothing to read where
no program with that span is loaded, or nothing was measured."""

import sys

TRACE_MODULE = "caffe_escoin_tpu_torch.utils.trace"
SPAN = "setup:autotune"


def read(run):
    trace = sys.modules.get(TRACE_MODULE)
    if trace is None:
        return None
    span = trace.snapshot()["spans"].get(SPAN)
    if span is None:
        return None
    counters = trace.snapshot()["counters"]
    print(f"autotune_setup_s: {span['count']} measurements, "
          f"{span['self_s']:.3f} s self, {span['total_s']:.3f} s in all; "
          f"picks {dict(sorted((k, n) for k, n in counters.items() if k.startswith('autotune.')))}",
          file=sys.stderr, flush=True)
    return span["self_s"]
