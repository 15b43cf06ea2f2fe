"""The whole step's share of the card's published bfloat16 peak: live
FLOPs of a batch x batches of the measured window / its length / peak."""


def read(run):
    if run.peak is None or run.work is None or run.window_s <= 0:
        return None
    flops = sum(w["flops"] for w in run.work.values())
    return 100.0 * flops * run.queries / run.window_s / run.peak["bf16_flop_s"]
