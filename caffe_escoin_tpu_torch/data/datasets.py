"""Synthetic dataset sources (port of ``caffe_escoin_tpu/data/datasets.py``,
its numpy sources; a copy, the same streams for the same seed). The
``.cerec`` record files come with the data port."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def synthetic_source(batch_shape: Tuple[int, ...], num_classes: int = 10,
                     seed: int = 0, dtype=np.float32):
    """Deterministic pseudo-data stream: returns a callable producing
    {"data": [B,...], "label": [B]} batches (numpy)."""
    rng = np.random.default_rng(seed)

    def source() -> Dict[str, np.ndarray]:
        data = rng.standard_normal(batch_shape).astype(dtype)
        label = rng.integers(0, num_classes, batch_shape[0]).astype(np.int32)
        return {"data": data, "label": label}

    return source


def classification_toy_source(batch: int, dim: int, num_classes: int,
                              seed: int = 0):
    """Linearly separable toy problem (training converges on it)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_classes, dim)).astype(np.float32) * 3

    def source():
        label = rng.integers(0, num_classes, batch).astype(np.int32)
        data = centers[label] + rng.standard_normal(
            (batch, dim)).astype(np.float32)
        return {"data": data, "label": label}

    return source
