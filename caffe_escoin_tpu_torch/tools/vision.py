"""Classifier / Detector convenience wrappers + image helpers (port of
``caffe_escoin_tpu/tools/vision.py``).

The pycaffe-parity layer (`python/caffe/classifier.py`, `detector.py`,
`io.py:311-378`): image classification with oversampling (center + 4
corners, mirrored = 10 crops) and R-CNN-style window detection with context
padding. Preprocessing is numpy on the host (per-image I/O work); the
forward is ``Net.inference_fn`` on the net's device (``Net.device``; None
means the card, and raises without one). PIL is imported where an image is
resized, not with the module.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from caffe_escoin_tpu_torch.nn.net import Net, params_to
from caffe_escoin_tpu_torch.utils.benchmark import force_platform


def resize_image(im: np.ndarray, new_dims: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize [H,W,C] float image (io.py:311-343, PIL backend)."""
    from PIL import Image

    if im.shape[:2] == tuple(new_dims):
        return im.astype(np.float32)
    scale = im.max() if im.max() > 0 else 1.0
    arr = np.uint8(np.clip(im / scale, 0, 1) * 255)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]  # PIL wants 2-D for single-channel
    img = Image.fromarray(arr)
    img = img.resize((new_dims[1], new_dims[0]), Image.BILINEAR)
    out = np.asarray(img, np.float32) / 255.0 * scale
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def oversample(images: Sequence[np.ndarray],
               crop_dims: Tuple[int, int]) -> np.ndarray:
    """10 crops per image: 4 corners + center, plus mirrors (io.py:346-378)."""
    ch, cw = crop_dims
    crops = []
    for im in images:
        h, w = im.shape[:2]
        starts = [(0, 0), (0, w - cw), (h - ch, 0), (h - ch, w - cw),
                  ((h - ch) // 2, (w - cw) // 2)]
        for (y, x) in starts:
            c = im[y:y + ch, x:x + cw]
            crops.append(c)
            crops.append(c[:, ::-1])
    return np.stack(crops).astype(np.float32)


class _Forward:
    """The net's forward on its device, from a numpy batch to the numpy
    ``output_name`` top (f32; a final top, as the JAX forward returns)."""

    def __init__(self, net: Net, params, input_name: str, output_name: str):
        self.device = (net.device if net.device is not None
                       else force_platform("auto"))
        self.input_name = input_name
        self.output_name = output_name
        self._fwd = net.inference_fn(params_to(params, self.device))

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        out = self._fwd({self.input_name: x})[self.output_name]
        return out.float().cpu().numpy()


class Classifier:
    """Image classifier over a Net (classifier.py:11-98).

    mean: per-channel mean; raw_scale: multiply input before mean subtract;
    image_dims: resize target before cropping to the net's input size.
    """

    def __init__(self, net: Net, params, *, input_name: str = "data",
                 output_name: str = "prob",
                 mean: Optional[Sequence[float]] = None,
                 raw_scale: float = 1.0,
                 image_dims: Optional[Tuple[int, int]] = None):
        self.net = net
        self.params = params
        self.input_name = input_name
        self.output_name = output_name
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.raw_scale = raw_scale
        in_shape = net.blob_shapes[input_name]
        self.crop_dims = (in_shape[1], in_shape[2])
        self.image_dims = image_dims or self.crop_dims
        self._fwd = _Forward(net, params, input_name, output_name)

    def _preprocess(self, im: np.ndarray) -> np.ndarray:
        im = resize_image(np.asarray(im, np.float32), self.image_dims)
        im = im * self.raw_scale
        if self.mean is not None:
            im = im - self.mean
        return im

    def predict(self, inputs: Sequence[np.ndarray],
                oversample_: bool = True) -> np.ndarray:
        """[images] -> (N, C) class probabilities; with oversampling the 10
        crop predictions are averaged (classifier.py:47-98)."""
        imgs = [self._preprocess(im) for im in inputs]
        if oversample_:
            batch = oversample(imgs, self.crop_dims)
        else:
            ch, cw = self.crop_dims
            cropped = []
            for im in imgs:
                y, x = (im.shape[0] - ch) // 2, (im.shape[1] - cw) // 2
                cropped.append(im[y:y + ch, x:x + cw])
            batch = np.stack(cropped).astype(np.float32)
        preds = self._fwd(batch)
        if oversample_:
            preds = preds.reshape(len(inputs), 10, -1).mean(axis=1)
        return preds


class Detector:
    """R-CNN-style window detector (detector.py:22-180): crop each proposal
    window with context padding, warp to the net input, classify."""

    def __init__(self, net: Net, params, *, input_name: str = "data",
                 output_name: str = "prob",
                 mean: Optional[Sequence[float]] = None,
                 raw_scale: float = 1.0, context_pad: int = 16):
        self.net = net
        self.params = params
        self.input_name = input_name
        self.output_name = output_name
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.raw_scale = raw_scale
        self.context_pad = context_pad
        in_shape = net.blob_shapes[input_name]
        self.crop_dims = (in_shape[1], in_shape[2])
        self._fwd = _Forward(net, params, input_name, output_name)

    def crop(self, im: np.ndarray, window) -> np.ndarray:
        """Crop window (y0, x0, y1, x1) with context padding, clipped to the
        image, warped to crop_dims (detector.py:125-178, simplified: clip
        instead of edge-replicate)."""
        y0, x0, y1, x1 = window
        pad = self.context_pad
        y0, x0 = max(0, y0 - pad), max(0, x0 - pad)
        y1 = min(im.shape[0], y1 + pad)
        x1 = min(im.shape[1], x1 + pad)
        patch = np.asarray(im[y0:y1, x0:x1], np.float32)
        return resize_image(patch, self.crop_dims)

    def detect_windows(self, images_windows: Sequence[Tuple[np.ndarray, Sequence]]
                       ) -> List[Dict]:
        """[(image, [window, ...]), ...] -> list of {window, prediction}."""
        crops, index = [], []
        for im, windows in images_windows:
            for wdw in windows:
                c = self.crop(im, wdw)
                c = c * self.raw_scale
                if self.mean is not None:
                    c = c - self.mean
                crops.append(c)
                index.append(wdw)
        if not crops:
            return []
        preds = self._fwd(np.stack(crops))
        return [{"window": w, "prediction": p} for w, p in zip(index, preds)]
