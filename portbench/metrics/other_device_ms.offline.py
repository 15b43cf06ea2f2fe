"""Device ms per batch charged to the layers that are neither pruned convs
nor pruned fcs (pools, LRN, Concat, softmax, unpruned layers), in the
layer-stepped forwards."""


def read(run):
    if not run.layer_us:
        return None
    pruned = set(run.pruned)
    return sum(us for name, us in run.layer_us.items()
               if name not in pruned) / 1e3
