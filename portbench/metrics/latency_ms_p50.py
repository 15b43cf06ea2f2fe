"""Median over every query of the window, from its issue to its logits
on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.latency_s, 50)) * 1e3
