"""The pruned convs' share of their roofline: the sum of their bounds
(max of live FLOPs / peak FLOP/s and bytes / peak byte/s) over the sum of
the device time charged to them in the layer-stepped forwards, whatever
kernel ran them."""

from portbench import counts


def read(run):
    if run.layer_us is None or run.work is None or run.peak is None:
        return None
    names = [n for n in run.pruned_convs if run.layer_us.get(n, 0) > 0]
    if len(names) != len(run.pruned_convs):
        return None  # a pruned conv with no device time charged
    bound = sum(counts.bound_s(run.work[n], run.peak) for n in names)
    spent = sum(run.layer_us[n] for n in names) * 1e-6
    return 100.0 * bound / spent
