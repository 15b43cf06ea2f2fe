"""The grouped convs' share of their roofline: the sum of the bounds of
the pruned convs whose reference entry has ``group`` > 1 (max of live
FLOPs / peak FLOP/s and bytes / peak byte/s) over the sum of the device
time charged to them in the layer-stepped forwards, whatever kernel ran
them. Live FLOPs count only the nonzero weights, so the zeros that a
kernel multiplies where its blocks do not follow the groups count as
lost. The groups come from the configuration's reference table; nothing
to read where the cell has no pruned grouped conv."""

import importlib

from portbench import counts


def read(run):
    if run.layer_us is None or run.work is None or run.peak is None:
        return None
    arch = importlib.import_module(
        f"portbench.reference.{run.config['reference']}")
    grouped = {e["name"] for e in arch.table(run.config["num_classes"])
               if e["type"] == "conv" and e["group"] > 1}
    names = [n for n in run.pruned_convs if n in grouped]
    if not names or any(run.layer_us.get(n, 0) <= 0 for n in names):
        return None  # no pruned grouped conv, or one with no device time
    bound = sum(counts.bound_s(run.work[n], run.peak) for n in names)
    spent = sum(run.layer_us[n] for n in names) * 1e-6
    return 100.0 * bound / spent
