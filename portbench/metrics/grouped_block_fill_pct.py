"""How full the grouped convs' blocks are: 100 x the nonzero weights the
program's grouped sparse convs store (``align.grouped.nnz``) over the
weights their kernels multiply, the live blocks of each GEMM view x bk x
bn (``align.grouped.block_slots``). The view lays the groups out
block-diagonally, so a block pruned in one group's (Cin/group, Cout)
plane that does not line up with the view's blocks is multiplied with
the zeros around it. Both are set-up counters of the program's
``Net.weight_align`` (``caffe_escoin_tpu_torch/utils/trace``), read from
its snapshot as ``autotune_setup_s`` reads its counters; nothing to read
where no program with those counters is loaded, or it aligned no grouped
sparse conv."""

import sys

TRACE_MODULE = "caffe_escoin_tpu_torch.utils.trace"
NNZ, SLOTS = "align.grouped.nnz", "align.grouped.block_slots"


def read(run):
    trace = sys.modules.get(TRACE_MODULE)
    if trace is None:
        return None
    counters = trace.snapshot()["counters"]
    if not counters.get(SLOTS):
        return None
    print(f"grouped_block_fill_pct: {counters.get('align.grouped.convs', 0)} "
          f"grouped convs, {counters.get(NNZ, 0)} nonzero weights in "
          f"{counters[SLOTS]} block slots", file=sys.stderr, flush=True)
    return 100.0 * counters.get(NNZ, 0) / counters[SLOTS]
