"""The pruned fcs' share of their roofline: the sum of their bounds (max
of live FLOPs / peak FLOP/s and bytes / peak byte/s) over the sum of the
device time charged to them in the layer-stepped forwards, whatever arm
ran them: the fc twin of ``sparse_conv_roofline_pct``."""

from portbench import counts


def read(run):
    if run.layer_us is None or run.work is None or run.peak is None:
        return None
    convs = set(run.pruned_convs)
    names = [n for n in run.pruned if n not in convs]
    if not names or any(run.layer_us.get(n, 0) <= 0 for n in names):
        return None  # no pruned fc, or one with no device time charged
    bound = sum(counts.bound_s(run.work[n], run.peak) for n in names)
    spent = sum(run.layer_us[n] for n in names) * 1e-6
    return 100.0 * bound / spent
