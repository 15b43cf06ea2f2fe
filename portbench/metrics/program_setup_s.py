"""The program's own set-up: the self time of its set-up spans
(``setup:*`` in ``caffe_escoin_tpu_torch/utils/trace``: the graph passes,
the move to the card, the kernels' load, the first call and the capture),
which it records with its tracing off. The builds are left out and
logged: nvcc and g++ run only on a checkout's first run. Nothing to read
where no program with spans is loaded."""

import sys

TRACE_MODULE = "caffe_escoin_tpu_torch.utils.trace"
BUILDS = ("setup:kernel_build", "setup:native_build")


def read(run):
    trace = sys.modules.get(TRACE_MODULE)
    if trace is None:
        return None
    setup = {name: s for name, s in trace.snapshot()["spans"].items()
             if name.startswith("setup:")}
    built = {name: setup.pop(name)["total_s"] for name in BUILDS
             if name in setup}
    if not setup:
        return None
    own = {name: s["self_s"] for name, s in setup.items()}
    print(f"program_setup_s: self seconds {own}; builds left out: {built}",
          file=sys.stderr, flush=True)
    return sum(own.values())
