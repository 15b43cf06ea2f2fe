"""The data layers (port of ``caffe_escoin_tpu/nn/data_layers.py``): Data
(.cerec and LMDB), MemoryData, ImageData, HDF5Data, HDF5Output and
WindowData.

Reference: `src/caffe/layers/{data,memory_data,image_data,hdf5_data,
hdf5_output,window_data}_layer.cpp`. As in the reference, a data layer's
forward pops a batch that a background thread prepared
(`BasePrefetchingDataLayer`, base_data_layer.hpp:52-78): here a
``data.pipeline.PrefetchLoader``, which runs the source and the
``DataTransformer`` on its thread, pins the batch when the device is the
card, and copies it there with ``non_blocking`` when the forward pops it.

A data layer has no bottom to take a device from: its tops land on
``self.device``, which ``Net`` sets from its own (None: the card, an error
without one). The transformer's phase is the spec's ``phase`` param, else
the layer's phase (``include``), else the net's. Each pop waits at most
``LOADER_TIMEOUT`` seconds. These layers are not ``graph_safe``: a net with
one runs eagerly. ``close()`` (or ``Net.close()``) joins the loader thread.

PIL (ImageData, WindowData) and h5py (HDF5Data, HDF5Output) are imported
inside the functions that use them, so the package imports without them.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from caffe_escoin_tpu_torch.data.datasets import (cerec_source,
                                                  read_cerec_header)
from caffe_escoin_tpu_torch.data.pipeline import PrefetchLoader
from caffe_escoin_tpu_torch.data.transformer import (DataTransformer,
                                                     TransformParams)
from caffe_escoin_tpu_torch.nn.net import Layer, register_layer

# seconds a forward waits for its batch before it raises TimeoutError
LOADER_TIMEOUT = 300.0


def _make_transformer(p, phase) -> Optional[DataTransformer]:
    """The DataTransformer of a data layer's ``transform_param`` (crop_size,
    mirror, scale, mean_value, mean_file: a .npy [H, W, C], seed), or None
    without one."""
    tp = p.get("transform_param")
    if not tp:
        return None
    params = TransformParams(
        crop_size=tp.get("crop_size", 0),
        mirror=tp.get("mirror", False),
        scale=tp.get("scale", 1.0),
        mean_value=tuple(tp["mean_value"]) if tp.get("mean_value") else None,
        phase=phase,
    )
    if tp.get("mean_file"):
        params.mean_image = np.load(tp["mean_file"]).astype(np.float32)
    return DataTransformer(params, seed=tp.get("seed", 0))


def resolve_device(device) -> torch.device:
    """A data layer's device: ``device``, or the card when it is None."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("a data layer's net has device None, which means "
                           "the card, and there is no CUDA device; build the "
                           "Net with device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


class _PrefetchingDataLayer(Layer):
    """Shared base: the PrefetchLoader is built on the first forward, and
    each forward pops one batch from it."""

    category = "data"
    graph_safe = False
    tops_from_batch = ("data", "label")

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self._loader: Optional[PrefetchLoader] = None

    @property
    def loader(self) -> Optional[PrefetchLoader]:
        """The running loader (None before the first forward): its
        ``waits`` are the host seconds each pop waited."""
        return self._loader

    def _source(self):  # -> callable yielding {"data": ..., "label": ...}
        raise NotImplementedError

    def _phase(self) -> str:
        return (self.p.get("phase") or self.spec.phase or self.net_phase
                or "train")

    def _crop_hw(self, h, w):
        cs = (self.p.get("transform_param") or {}).get("crop_size", 0)
        return (cs, cs) if cs else (h, w)

    def forward(self, params, inputs, state=None):
        if self._loader is None:
            self._loader = PrefetchLoader(
                self._source(),
                transform=_make_transformer(self.p, self._phase()),
                device=resolve_device(self.device), timeout=LOADER_TIMEOUT)
        batch = next(self._loader)
        return [batch[k] for k in self.tops_from_batch if k in batch]

    def close(self):
        if self._loader is not None:
            self._loader.close()
            self._loader = None


def _is_lmdb(p) -> bool:
    src = p["source"]
    if str(p.get("backend", "")).lower() in ("lmdb", "1"):
        return True
    return src.endswith(".mdb") or os.path.exists(os.path.join(src,
                                                               "data.mdb"))


@register_layer("Data")
class DataLayer(_PrefetchingDataLayer):
    """Record-database data layer (data_layer.cpp): a sequential cursor over
    a ``.cerec`` file (data/datasets.py) or a reference LMDB of Datum
    records (data/lmdb_io.py: ``backend: "lmdb"`` or LMDB, or a source
    path that is a ``.mdb`` file or holds ``data.mdb``). Labels are int32
    from ``.cerec``, int64 from LMDB."""

    def _source(self):
        if _is_lmdb(self.p):
            from caffe_escoin_tpu_torch.data.lmdb_io import lmdb_source

            return lmdb_source(self.p["source"], self.p["batch_size"])
        return cerec_source(self.p["source"], self.p["batch_size"])

    def out_shapes(self, in_shapes):
        n = self.p["batch_size"]
        if _is_lmdb(self.p):
            from caffe_escoin_tpu_torch.data.lmdb_io import (LmdbReader,
                                                             datum_decode)

            _, v = next(LmdbReader(self.p["source"]).items())
            h, w, c = datum_decode(v)[0].shape
        else:
            h, w, c = read_cerec_header(self.p["source"])["sample_shape"]
        return [(n, *self._crop_hw(h, w), c), (n,)]


@register_layer("MemoryData")
class MemoryDataLayer(_PrefetchingDataLayer):
    """In-memory dataset (memory_data_layer.cpp). ``reset(data, labels)``
    is MemoryDataLayer::Reset; batches cycle through the arrays."""

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self._data = None
        self._labels = None
        self._pos = 0

    def reset(self, data, labels):
        data = np.asarray(data, np.float32)
        labels = np.asarray(labels, np.float32)
        n = self.p["batch_size"]
        if len(data) % n != 0:
            raise ValueError(  # memory_data_layer.cpp:80 CHECK
                f"data size {len(data)} not divisible by batch_size {n}")
        self._data, self._labels, self._pos = data, labels, 0
        self.close()  # a running loader read the old arrays

    def _source(self):
        if self._data is None:
            raise RuntimeError("MemoryData: call reset(data, labels) first")
        n = self.p["batch_size"]

        def src():
            i = self._pos
            self._pos = (i + n) % len(self._data)
            return {"data": self._data[i:i + n],
                    "label": self._labels[i:i + n]}

        return src

    def out_shapes(self, in_shapes):
        n = self.p["batch_size"]
        return [(n, self.p["height"], self.p["width"], self.p["channels"]),
                (n,)]


def load_image(path, *, color=True, new_height=0, new_width=0):
    """An image file as float32 [H, W, C] (C = 3, or 1 for gray), resized
    bilinearly to new_height x new_width when both are set (PIL where the
    reference uses OpenCV)."""
    from PIL import Image

    img = Image.open(path)
    img = img.convert("RGB" if color else "L")
    if new_height and new_width:
        img = img.resize((new_width, new_height), Image.BILINEAR)
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


@register_layer("ImageData")
class ImageDataLayer(_PrefetchingDataLayer):
    """Image-list data layer (image_data_layer.cpp): ``source`` is a text
    file of "<path> <label>" lines under ``root_folder``; images are
    decoded and resized to new_height x new_width on the loader's thread;
    ``shuffle`` permutes the list once, from ``seed``."""

    def _lines(self):
        root = self.p.get("root_folder", "")
        with open(self.p["source"]) as f:
            entries = [ln.split() for ln in f if ln.strip()]
        return [(os.path.join(root, p), float(l)) for p, l in entries]

    def _load(self, path):
        return load_image(path, color=self.p.get("is_color", True),
                          new_height=self.p.get("new_height", 0),
                          new_width=self.p.get("new_width", 0))

    def _source(self):
        entries = self._lines()
        if self.p.get("shuffle", False):
            rng = np.random.default_rng(self.p.get("seed", 0))
            rng.shuffle(entries)
        n = self.p["batch_size"]
        pos = [0]

        def src():
            imgs, labels = [], []
            for _ in range(n):
                path, label = entries[pos[0] % len(entries)]
                pos[0] += 1
                imgs.append(self._load(path))
                labels.append(label)
            return {"data": np.stack(imgs),
                    "label": np.asarray(labels, np.float32)}

        return src

    def out_shapes(self, in_shapes):
        h, w, c = self._load(self._lines()[0][0]).shape
        n = self.p["batch_size"]
        return [(n, *self._crop_hw(h, w), c), (n,)]


@register_layer("HDF5Data")
class HDF5DataLayer(_PrefetchingDataLayer):
    """HDF5 data layer (hdf5_data_layer.cpp): ``source`` lists .h5 files;
    each dataset named by a top becomes that top. One file is in memory at
    a time (LoadHDF5FileData on rollover, `hdf5_data_layer.cpp:27,111,
    142`), and batches span file boundaries. With ``shuffle`` the file
    order and the rows within each file are permuted per epoch, the first
    epoch too, from ``seed``."""

    @property
    def tops_from_batch(self):
        return tuple(self.spec.tops)

    def _files(self):
        with open(self.p["source"]) as f:
            return [ln.strip() for ln in f if ln.strip()]

    def _source(self):
        import h5py

        files = self._files()
        tops = list(self.spec.tops)
        n = self.p["batch_size"]
        shuffle = self.p.get("shuffle", False)
        rng = np.random.default_rng(self.p.get("seed", 0))
        file_order = list(range(len(files)))
        if shuffle:
            rng.shuffle(file_order)
        state = {"fi": 0, "pos": 0, "cur": None, "order": None}

        def load_current():
            with h5py.File(files[file_order[state["fi"]]], "r") as h5:
                state["cur"] = {t: np.asarray(h5[t], np.float32)
                                for t in tops}
            order = np.arange(len(state["cur"][tops[0]]))
            if shuffle:
                rng.shuffle(order)
            state["order"], state["pos"] = order, 0

        def src():
            out = {t: [] for t in tops}
            need = n
            while need > 0:
                if state["cur"] is None:
                    load_current()
                take = min(need, len(state["order"]) - state["pos"])
                idx = state["order"][state["pos"]:state["pos"] + take]
                for t in tops:
                    out[t].append(state["cur"][t][idx])
                state["pos"] += take
                need -= take
                if state["pos"] >= len(state["order"]):
                    state["cur"] = None  # free this file before the next
                    state["fi"] += 1
                    if state["fi"] >= len(files):  # epoch rollover
                        state["fi"] = 0
                        if shuffle:
                            rng.shuffle(file_order)
            return {t: np.concatenate(out[t]) if len(out[t]) > 1
                    else out[t][0] for t in tops}

        return src

    def out_shapes(self, in_shapes):
        import h5py

        n = self.p["batch_size"]
        with h5py.File(self._files()[0], "r") as h5:
            return [(n,) + tuple(h5[t].shape[1:]) for t in self.spec.tops]


@register_layer("HDF5Output")
class HDF5OutputLayer(Layer):
    """Writes its bottoms to an HDF5 file (hdf5_output_layer.cpp): datasets
    "data" and "label" (then "top2", "top3"), appended over forward calls
    as host copies; ``flush()`` writes the file."""

    category = "data"
    graph_safe = False

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self._chunks: List[List[np.ndarray]] = []

    def forward(self, params, inputs, state=None):
        self._chunks.append([b.detach().cpu().numpy() for b in inputs])
        return []

    def flush(self):
        import h5py

        names = ["data", "label", "top2", "top3"]
        with h5py.File(self.p["file_name"], "w") as h5:
            if self._chunks:
                for i in range(len(self._chunks[0])):
                    h5.create_dataset(
                        names[i],
                        data=np.concatenate([c[i] for c in self._chunks]))
        self._chunks = []

    def out_shapes(self, in_shapes):
        return []


@register_layer("WindowData")
class WindowDataLayer(_PrefetchingDataLayer):
    """R-CNN window sampling (window_data_layer.cpp). ``source`` is the
    R-CNN window file:

        # <image_index>
        <image_path>
        <channels> <height> <width>
        <num_windows>
        <class_index> <overlap> <x1> <y1> <x2> <y2>
        ...

    Each batch draws round(fg_fraction * batch_size) foreground windows
    (overlap >= fg_threshold) and the rest background (overlap <
    bg_threshold, labelled 0), from ``seed``; each window, grown by
    ``context_pad``, is warped to crop_size x crop_size."""

    def _parse(self):
        images, windows = [], []
        with open(self.p["source"]) as f:
            lines = [ln.rstrip("\n") for ln in f]
        i = 0
        while i < len(lines):
            if not lines[i].startswith("#"):
                i += 1
                continue
            path = lines[i + 1].strip()
            num = int(lines[i + 3])
            img_id = len(images)
            images.append(path)
            for j in range(num):
                cls, ov, x1, y1, x2, y2 = lines[i + 4 + j].split()
                windows.append((img_id, int(cls), float(ov), int(x1),
                                int(y1), int(x2), int(y2)))
            i += 4 + num
        return images, windows

    def _source(self):
        from PIL import Image

        images, windows = self._parse()
        fg_thr = self.p.get("fg_threshold", 0.5)
        bg_thr = self.p.get("bg_threshold", 0.5)
        fg = [w for w in windows if w[2] >= fg_thr]
        bg = [w for w in windows if w[2] < bg_thr]
        n = self.p["batch_size"]
        n_fg = int(round(n * self.p.get("fg_fraction", 0.25)))
        cs = self.p.get("crop_size", 227)
        pad = self.p.get("context_pad", 0)
        rng = np.random.default_rng(self.p.get("seed", 0))
        cache = {}

        def crop(win):
            img_id, cls, _, x1, y1, x2, y2 = win
            if img_id not in cache:
                cache[img_id] = Image.open(images[img_id]).convert("RGB")
            img = cache[img_id]
            box = (max(0, x1 - pad), max(0, y1 - pad),
                   min(img.width, x2 + pad), min(img.height, y2 + pad))
            patch = img.crop(box).resize((cs, cs), Image.BILINEAR)
            return np.asarray(patch, np.float32), float(cls)

        def src():
            picks = ([fg[rng.integers(len(fg))] for _ in range(n_fg)]
                     if fg else [])
            picks += [bg[rng.integers(len(bg))]
                      for _ in range(n - len(picks))] if bg else []
            while len(picks) < n:  # no background window: repeat fg
                picks.append(fg[rng.integers(len(fg))])
            data, labels = zip(*[crop(w) for w in picks])
            labels = [0.0 if w[2] < fg_thr else l
                      for w, l in zip(picks, labels)]
            return {"data": np.stack(data),
                    "label": np.asarray(labels, np.float32)}

        return src

    def out_shapes(self, in_shapes):
        n = self.p["batch_size"]
        cs = self.p.get("crop_size", 227)
        return [(n, cs, cs, 3), (n,)]
