"""The offline digits dataset of the examples (port of
``examples/train_eval_sparse.py``'s ``log`` and ``load_digits_upscaled``).

``data/digits.csv.gz`` is an unchanged copy of the file scikit-learn ships
as ``sklearn/datasets/data/digits.csv.gz`` (scikit-learn 1.9.0, BSD-3
licence): the test set of the UCI ML "Optical Recognition of Handwritten
Digits" data (E. Alpaydin, C. Kaynak, 1998), 1797 real 8x8 images with
pixel counts 0-16. Each line holds the 64 pixels in row order and then the
label. It is read here with ``gzip`` and ``numpy.loadtxt``, as
``sklearn.datasets.load_digits`` reads it, so the port needs no
scikit-learn.
"""

from __future__ import annotations

import gzip
import sys
from pathlib import Path

import numpy as np

DATA_FILE = Path(__file__).resolve().parent / "data" / "digits.csv.gz"
N_TEST = 256


def log(m):
    print(m, file=sys.stderr, flush=True)


def load_digits():
    """(images [1797, 8, 8] float64 with values 0-16, labels [1797] int64),
    in the file's order: what ``sklearn.datasets.load_digits()`` returns
    as ``images`` and ``target``."""
    with gzip.open(DATA_FILE, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1].reshape(-1, 8, 8), data[:, -1].astype(int)


def load_digits_upscaled(size, channels):
    """The digits nearest-neighbour upscaled by ``size // 8`` (kron), centre
    padded to ``size`` x ``size``, NHWC with ``channels`` copies, scaled to
    [0, 1], shuffled by a seed-0 permutation: ((train images, labels),
    (test images, labels)), the first 256 shuffled images the test set."""
    images, target = load_digits()
    imgs = images.astype(np.float32) / 16.0  # [1797, 8, 8] in [0,1]
    reps = size // 8
    imgs = np.kron(imgs, np.ones((1, reps, reps), np.float32))
    pad = size - imgs.shape[1]
    if pad:
        imgs = np.pad(imgs, ((0, 0), (pad // 2, pad - pad // 2),
                             (pad // 2, pad - pad // 2)))
    imgs = imgs[..., None]
    if channels > 1:
        imgs = np.repeat(imgs, channels, axis=-1)
    labels = target.astype(np.int32)
    rng = np.random.default_rng(0)
    order = rng.permutation(len(imgs))
    imgs, labels = imgs[order], labels[order]
    return ((imgs[N_TEST:], labels[N_TEST:]),
            (imgs[:N_TEST], labels[:N_TEST]))
