"""Dataset sources (port of ``caffe_escoin_tpu/data/datasets.py``; a numpy
copy: the same streams for the same seed, and the same ``.cerec`` bytes).

The synthetic sources give deterministic MNIST/CIFAR/ImageNet-shaped
batches. ``.cerec`` is the JAX package's record file, read by the numpy
``cerec_source`` here and by the C++ prefetcher of ``data/native.py``:

  header:  b"CERC" | u32 version (1) | u32 ndim | u32 dims... | u32 num
  records: u32 payload_len | payload (f32 sample) | i32 label
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

MAGIC = b"CERC"


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


def write_cerec(path: str, data: np.ndarray, labels: np.ndarray):
    """data: [N, ...] (stored as float32), labels: [N] (stored as int32)."""
    data = np.ascontiguousarray(data, np.float32)
    labels = np.ascontiguousarray(labels, np.int32)
    n = data.shape[0]
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", 1, data.ndim - 1))
        for d in data.shape[1:]:
            f.write(struct.pack("<I", d))
        f.write(struct.pack("<I", n))
        rec = data.reshape(n, -1)
        for i in range(n):
            payload = rec[i].tobytes()
            f.write(struct.pack("<I", len(payload)))
            f.write(payload)
            f.write(struct.pack("<i", int(labels[i])))


def read_cerec_header(path: str):
    """{"version", "sample_shape", "num", "data_offset"} of a .cerec file."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a cerec file")
        version, ndim = struct.unpack("<II", f.read(8))
        dims = struct.unpack("<" + "I" * ndim, f.read(4 * ndim))
        (n,) = struct.unpack("<I", f.read(4))
        return {"version": version, "sample_shape": dims, "num": n,
                "data_offset": f.tell()}


def cerec_source(path: str, batch: int, *, loop: bool = True):
    """Batch source over a .cerec file, read through a memory map: each call
    returns {"data": [B, ...] float32, "label": [B] int32} from a cursor
    that wraps (``loop``) or raises StopIteration at the end."""
    hdr = read_cerec_header(path)
    shape = hdr["sample_shape"]
    n = hdr["num"]
    sample_bytes = int(np.prod(shape)) * 4
    rec_bytes = 4 + sample_bytes + 4
    raw = np.memmap(path, dtype=np.uint8, mode="r", offset=hdr["data_offset"])
    idx = {"pos": 0}

    def source():
        datas = np.empty((batch,) + tuple(shape), np.float32)
        labels = np.empty((batch,), np.int32)
        for b in range(batch):
            i = idx["pos"]
            if i >= n:
                if not loop:
                    raise StopIteration
                i = idx["pos"] = 0
            off = i * rec_bytes
            payload = raw[off + 4:off + 4 + sample_bytes]
            datas[b] = np.frombuffer(payload, np.float32).reshape(shape)
            labels[b] = struct.unpack(
                "<i", raw[off + 4 + sample_bytes:off + rec_bytes].tobytes())[0]
            idx["pos"] = i + 1
        return {"data": datas, "label": labels}

    return source
