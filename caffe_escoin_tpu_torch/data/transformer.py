"""Data transformer: mean subtraction, scale, crop and mirror (port of
``caffe_escoin_tpu/data/transformer.py``; numpy, since it runs on a
loader's thread).

Reference: `DataTransformer<Dtype>::Transform`
(`src/caffe/data_transformer.cpp`): the mean (per-pixel ``mean_image`` or
per-channel ``mean_value``) is subtracted, then ``scale`` applied; TEST
takes the center crop, TRAIN a random crop and a horizontal mirror with
probability one half. NHWC instead of the reference's CHW.

TEST computes what the JAX transformer computes, in the same order. TRAIN
follows Caffe where the JAX transformer does not: Caffe draws the mirror
coin and the crop offsets per *image*, the JAX transformer one offset and
one coin per batch. Here each image draws, from the transformer's
``np.random.Generator`` and in Caffe's order, its mirror coin (when
``mirror``) and then its crop offsets (when ``crop_size``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TransformParams:
    crop_size: int = 0
    mirror: bool = False
    scale: float = 1.0
    mean_value: Optional[Tuple[float, ...]] = None  # per-channel
    mean_image: Optional[np.ndarray] = None  # per-pixel [H,W,C]
    phase: str = "train"


class DataTransformer:
    """``transformer(batch)`` -> a new batch dict whose ``"data"`` ([N, H,
    W, C], any dtype) is transformed into contiguous float32; the other
    entries pass through."""

    def __init__(self, params: TransformParams, seed: int = 0):
        self.p = params
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch):
        out = dict(batch)
        x = np.asarray(batch["data"], np.float32)
        n, h, w, c = x.shape
        p = self.p
        if p.mean_image is not None:
            x = x - p.mean_image[None]
        elif p.mean_value is not None:
            x = x - np.asarray(p.mean_value, np.float32)
        if p.scale != 1.0:
            x = x * p.scale
        train = p.phase == "train"
        if train and (p.crop_size or p.mirror):
            cs_h = p.crop_size or h
            cs_w = p.crop_size or w
            y = np.empty((n, cs_h, cs_w, c), np.float32)
            for i in range(n):
                flip = p.mirror and self.rng.integers(0, 2) == 1
                oy = ox = 0
                if p.crop_size:
                    oy = self.rng.integers(0, h - cs_h + 1)
                    ox = self.rng.integers(0, w - cs_w + 1)
                img = x[i, oy:oy + cs_h, ox:ox + cs_w, :]
                y[i] = img[:, ::-1, :] if flip else img
            out["data"] = y
            return out
        if p.crop_size:  # center crop (data_transformer.cpp:64-66)
            cs = p.crop_size
            oy, ox = (h - cs) // 2, (w - cs) // 2
            x = x[:, oy:oy + cs, ox:ox + cs, :]
        out["data"] = np.ascontiguousarray(x)
        return out
