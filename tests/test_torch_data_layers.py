"""The six data layers against the JAX package's (the cases of
tests/test_data_layers.py and tests/test_lmdb_io.py's data layer, on
files each test writes): Data over ``.cerec`` and LMDB (with a TEST
transform), MemoryData, ImageData, HDF5Data (streaming across files,
shuffled), HDF5Output and WindowData. Each layer of the port pops the same
batches as the JAX layer from the same files and seeds, as CPU tensors
(the net's device), with the same ``out_shapes``.

Also: a prototxt whose Data layer reads an LMDB
(``net_from_prototxt(..., synthesize_data=False)``) builds a Net that runs,
its data top the transformed batch; a Solver trains from a Data layer as
from the same batches fed by hand; a data layer on a net whose device is
None (the card) refuses to run without one; ``inference_fn(cuda_graph=
True)`` refuses such a net, naming the layer. Every loader thread a test
starts is joined by its end (the ``no_stray_threads`` fixture).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import \
    ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JSpec  # noqa: E402
from caffe_escoin_tpu.nn.net import LAYER_REGISTRY as JREG  # noqa: E402

from caffe_escoin_tpu_torch.data import datasets, lmdb_io  # noqa: E402
from caffe_escoin_tpu_torch.engine.context import \
    ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.nn import LayerSpec, Net  # noqa: E402
from caffe_escoin_tpu_torch.nn.net import LAYER_REGISTRY  # noqa: E402


@pytest.fixture(autouse=True)
def no_stray_threads():
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        stray = [t for t in threading.enumerate()
                 if t not in before and t.is_alive()]
        if not stray:
            return
        time.sleep(0.05)
    raise AssertionError(f"threads outlived the test: {stray}")


def _pair(type_name, tops=("data", "label"), bottoms=(), **params):
    """The JAX layer and the port's (on the CPU) for one spec."""
    jl = JREG[type_name](JSpec("l", type_name, list(bottoms), list(tops),
                               params=params), JPolicy())
    pl = LAYER_REGISTRY[type_name](LayerSpec("l", type_name, bottoms, tops,
                                             params=params),
                                   ExecutionPolicy())
    pl.device = torch.device("cpu")
    return jl, pl


def _same_batches(jl, pl, n, exact_dtype=None):
    try:
        for _ in range(n):
            want = jl.apply({}, [], train=True, rng=None)
            got = pl({}, [])
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.device.type == "cpu"
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if exact_dtype is not None:
            assert got[-1].dtype == exact_dtype
    finally:
        jl.close()
        pl.close()


def test_data_layer_cerec(tmp_path):
    path = str(tmp_path / "train.cerec")
    data = np.arange(8 * 6 * 6 * 3, dtype=np.float32).reshape(8, 6, 6, 3)
    datasets.write_cerec(path, data, np.arange(8, dtype=np.float32))
    jl, pl = _pair("Data", source=path, batch_size=3)
    assert pl.out_shapes([]) == jl.out_shapes({}, []) == [(3, 6, 6, 3),
                                                          (3,)]
    _same_batches(jl, pl, 4, torch.int32)  # 12 records: wraps once


def _lmdb(tmp_path, n=6, hw=(6, 6)):
    rng = np.random.default_rng(3)
    p = str(tmp_path / "db")
    os.makedirs(p)
    items = [(b"%08d" % i, lmdb_io.datum_encode(
        rng.integers(0, 256, hw + (3,), dtype=np.uint8), label=i))
        for i in range(n)]
    lmdb_io.write_lmdb(p, items)
    return p


def test_data_layer_lmdb(tmp_path):
    p = _lmdb(tmp_path)
    jl, pl = _pair("Data", source=p, batch_size=4)
    assert pl.out_shapes([]) == jl.out_shapes({}, []) == [(4, 6, 6, 3),
                                                          (4,)]
    _same_batches(jl, pl, 3, torch.int64)


def test_data_layer_lmdb_test_transform(tmp_path):
    """TEST phase: the mean image and the center crop, as the JAX layer
    (whose per-batch TRAIN draw the port replaces with Caffe's per-image
    one, so only TEST is compared)."""
    p = _lmdb(tmp_path, hw=(9, 8))
    mean = np.random.default_rng(0).uniform(0, 255, (9, 8, 3)).astype(
        np.float32)
    np.save(tmp_path / "mean.npy", mean)
    tp = dict(crop_size=5, mean_file=str(tmp_path / "mean.npy"), scale=0.5,
              mirror=True)
    jl, pl = _pair("Data", source=p, batch_size=4, backend="LMDB",
                   transform_param=tp, phase="test")
    assert pl.out_shapes([]) == [(4, 5, 5, 3), (4,)]
    _same_batches(jl, pl, 2)


def test_memory_data_layer():
    jl, pl = _pair("MemoryData", batch_size=2, channels=3, height=4,
                   width=4)
    data = np.random.default_rng(0).standard_normal((6, 4, 4, 3))
    labels = np.arange(6, dtype=np.float32)
    jl.reset(data, labels)
    pl.reset(data, labels)
    assert pl.out_shapes([]) == [(2, 4, 4, 3), (2,)]
    _same_batches(jl, pl, 4, torch.float32)
    with pytest.raises(ValueError, match="divisible"):
        pl.reset(data[:5], labels[:5])
    with pytest.raises(RuntimeError, match="reset"):
        _pair("MemoryData", batch_size=2, channels=3, height=4,
              width=4)[1]({}, [])


def test_image_data_layer(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)
                        ).save(tmp_path / f"im{i}.png")
    src = tmp_path / "list.txt"
    src.write_text("".join(f"im{i}.png {i}\n" for i in range(3)))
    for shuffle in (False, True):
        jl, pl = _pair("ImageData", source=str(src),
                       root_folder=str(tmp_path), batch_size=2,
                       new_height=8, new_width=8, shuffle=shuffle, seed=4)
        assert pl.out_shapes([]) == jl.out_shapes({}, []) == \
            [(2, 8, 8, 3), (2,)]
        _same_batches(jl, pl, 3, torch.float32)


def _h5(tmp_path, sizes):
    h5py = pytest.importorskip("h5py")
    paths = []
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"f{i}.h5")
        with h5py.File(p, "w") as h5:
            h5["data"] = np.random.default_rng(i).standard_normal(
                (n, 2)).astype(np.float32) + 10 * i
            h5["label"] = np.arange(n, dtype=np.float32) + 10 * i
        paths.append(p)
    src = tmp_path / "list.txt"
    src.write_text("".join(p + "\n" for p in paths))
    return str(src)


@pytest.mark.parametrize("shuffle", [False, True])
def test_hdf5_data_streams_across_files(tmp_path, shuffle):
    src = _h5(tmp_path, (3, 2, 4))
    jl, pl = _pair("HDF5Data", source=src, batch_size=4, shuffle=shuffle,
                   seed=2)
    assert pl.out_shapes([]) == jl.out_shapes({}, []) == [(4, 2), (4,)]
    _same_batches(jl, pl, 5)
    if not shuffle:  # test_data_layers.py's order, spanning the files
        _, pl = _pair("HDF5Data", source=src, batch_size=4)
        try:
            firsts = [pl({}, [])[1].tolist() for _ in range(3)]
        finally:
            pl.close()
        assert firsts[0] == [0, 1, 2, 10] and firsts[1] == [11, 20, 21, 22]
        assert firsts[2] == [23, 0, 1, 2]


def test_hdf5_output_layer(tmp_path):
    h5py = pytest.importorskip("h5py")
    outs = []
    for name in ("port", "jax"):
        path = str(tmp_path / f"{name}.h5")
        jl, pl = _pair("HDF5Output", tops=(), bottoms=("data", "label"),
                       file_name=path)
        layer = pl if name == "port" else jl
        for k in (1.0, 2.0):
            xs = [np.full((2, 3), k, np.float32), np.arange(2.0) * k]
            if name == "port":
                assert layer({}, [torch.from_numpy(x) for x in xs]) == []
            else:
                layer.apply({}, [jnp.asarray(x) for x in xs], train=False,
                            rng=None)
        layer.flush()
        with h5py.File(path) as h5:
            outs.append({k: np.asarray(h5[k]) for k in h5})
    assert set(outs[0]) == {"data", "label"}
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert outs[0]["data"].shape == (4, 3)


def test_window_data_layer(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = str(tmp_path / "scene.png")
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (64, 64, 3), dtype=np.uint8)).save(img)
    win = tmp_path / "windows.txt"
    win.write_text("# 0\n" f"{img}\n" "3 64 64\n" "3\n"
                   "1 0.9 4 4 40 40\n" "2 0.7 10 10 30 30\n"
                   "0 0.1 0 0 20 20\n")
    jl, pl = _pair("WindowData", source=str(win), batch_size=4,
                   crop_size=16, fg_threshold=0.5, bg_threshold=0.5,
                   fg_fraction=0.5, context_pad=2, seed=1)
    assert pl.out_shapes([]) == [(4, 16, 16, 3), (4,)]
    _same_batches(jl, pl, 3)


PROTOTXT = """
name: "dbnet"
layer {{ name: "data" type: "Data" top: "data" top: "label"
  include {{ phase: TEST }}
  transform_param {{ crop_size: 5 mean_file: "{mean}" }}
  data_param {{ source: "{db}" batch_size: 4 backend: LMDB }} }}
layer {{ name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param {{ num_output: 4 kernel_size: 3 pad: 1 }} }}
layer {{ name: "relu" type: "ReLU" bottom: "conv" top: "conv" }}
layer {{ name: "fc" type: "InnerProduct" bottom: "conv" top: "fc"
  inner_product_param {{ num_output: 8 }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label"
  top: "loss" }}
"""


def test_prototxt_data_layer_builds_and_runs_a_net(tmp_path):
    from caffe_escoin_tpu_torch.data.transformer import (DataTransformer,
                                                         TransformParams)
    from caffe_escoin_tpu_torch.tools.prototxt import net_from_prototxt

    db = _lmdb(tmp_path, n=8, hw=(7, 7))
    mean = np.full((7, 7, 3), 100.0, np.float32)
    np.save(tmp_path / "m.npy", mean)
    specs, shapes, _ = net_from_prototxt(
        PROTOTXT.format(db=db, mean=tmp_path / "m.npy"),
        synthesize_data=False)
    assert shapes == {} and specs[0].type == "Data"
    assert specs[0].params["transform_param"]["crop_size"] == 5
    net = Net(specs, phase="test", device="cpu")
    try:
        params = net.init(torch.Generator().manual_seed(0), shapes)
        assert net.blob_shapes["data"] == (4, 5, 5, 3)
        with pytest.raises(ValueError, match=r"data \(Data\)"):
            net.inference_fn(params, cuda_graph=True)
        want = DataTransformer(TransformParams(
            crop_size=5, mean_image=mean, phase="test"))(
            lmdb_io.lmdb_source(db, 4)())
        out = net(params, {}, return_blobs=True)
        np.testing.assert_array_equal(out["data"].numpy(), want["data"])
        np.testing.assert_array_equal(out["label"].numpy(), want["label"])
        assert torch.isfinite(out["loss"]) and out["fc"].shape == (4, 8)
        ref = Net(specs[1:], device="cpu")(params, {
            "data": torch.from_numpy(want["data"]),
            "label": torch.from_numpy(want["label"])})
        torch.testing.assert_close(out["loss"], ref["loss"])
    finally:
        net.close()


def test_solver_trains_from_a_data_layer(tmp_path):
    """A Solver on a net whose Data layer reads a .cerec takes the same
    steps as on the same batches fed through Input blobs."""
    from caffe_escoin_tpu_torch.engine.solver import Solver
    from caffe_escoin_tpu_torch.engine.solvers import SolverConfig

    rng = np.random.default_rng(0)
    path = str(tmp_path / "t.cerec")
    datasets.write_cerec(path, rng.standard_normal((12, 4, 4, 2)),
                         rng.integers(0, 3, 12))
    body = [LayerSpec("fc", "InnerProduct", ("data",),
                      params=dict(num_output=3)),
            LayerSpec("loss", "SoftmaxWithLoss", ("fc", "label"))]
    fed = Net([LayerSpec("data", "Data", (), ("data", "label"),
                         params=dict(source=path, batch_size=4))] + body,
              phase="train")
    cfg = SolverConfig(base_lr=0.1, momentum=0.9)
    a = Solver(fed, cfg, device="cpu", display=1)
    b = Solver(Net(body, phase="train"), cfg, device="cpu", display=1)
    assert fed.device == torch.device("cpu")
    try:
        a.init({})
        b.init({"data": (4, 4, 4, 2), "label": (4,)})
        logs_a, logs_b = [], []
        a.step(iter([{}] * 4), 4, log=logs_a.append)
        src = datasets.cerec_source(path, 4)
        b.step(iter([src() for _ in range(4)]), 4, log=logs_b.append)
        assert logs_a == logs_b and len(logs_a) == 4
        for k in ("w", "b"):
            torch.testing.assert_close(a.params["fc"][k], b.params["fc"][k])
    finally:
        fed.close()


def test_a_data_layer_on_the_card_needs_one(tmp_path, monkeypatch):
    path = str(tmp_path / "d.cerec")
    datasets.write_cerec(path, np.zeros((4, 2, 2, 1)), np.zeros(4))
    net = Net([LayerSpec("data", "Data", (), ("data", "label"),
                         params=dict(source=path, batch_size=2))])
    assert net.device is None  # the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        net({}, {})
    net.device = "cpu"
    try:
        assert net.layers[0].device == torch.device("cpu")
        assert net({}, {})["data"].shape == (2, 2, 2, 1)
    finally:
        net.close()


def test_a_stalled_source_times_out():
    from caffe_escoin_tpu_torch.data.pipeline import PrefetchLoader

    gate = threading.Event()

    def source():
        gate.wait(10.0)
        return {"x": np.zeros(1)}

    loader = PrefetchLoader(source, timeout=1.0)
    try:
        with pytest.raises(TimeoutError, match="no batch within"):
            next(loader)
    finally:
        gate.set()
        loader.close()


# every key the JAX data layers read, as a prototxt writes it: (type,
# parameter message, its fields, transform_param's fields)
PROTOTXT_KEYS = [
    ("Data", "data_param", 'source: "db" batch_size: 4 backend: LMDB '
     'seed: 2', 'crop_size: 5 mirror: true scale: 0.5 mean_value: 1 '
     'mean_value: 2 mean_file: "m.npy" seed: 3'),
    ("MemoryData", "memory_data_param", "batch_size: 4 channels: 3 "
     "height: 5 width: 6", None),
    ("ImageData", "image_data_param", 'source: "l.txt" root_folder: "r/" '
     'batch_size: 4 shuffle: true seed: 1 is_color: false new_height: 7 '
     'new_width: 8', "crop_size: 5"),
    ("HDF5Data", "hdf5_data_param", 'source: "h.txt" batch_size: 4 '
     'shuffle: true seed: 2', None),
    ("HDF5Output", "hdf5_output_param", 'file_name: "o.h5"', None),
    ("WindowData", "window_data_param", 'source: "w.txt" batch_size: 4 '
     'fg_threshold: 0.6 bg_threshold: 0.4 fg_fraction: 0.3 crop_size: 9 '
     'context_pad: 2 seed: 5', None),
]


@pytest.mark.parametrize("kind,msg,fields,tp", PROTOTXT_KEYS,
                         ids=[k[0] for k in PROTOTXT_KEYS])
def test_prototxt_carries_every_data_key(kind, msg, fields, tp):
    """``synthesize_data=False`` passes each field of the layer's parameter
    message to the spec under its own name (``backend`` as text,
    ``mean_value`` as a list) and ``transform_param`` as a dict; ``batch``
    overrides ``batch_size``."""
    from caffe_escoin_tpu_torch.tools.prototxt import (net_from_prototxt,
                                                       parse_text)

    text = (f'layer {{ name: "d" type: "{kind}" top: "data" top: "label" '
            f'{msg} {{ {fields} }}'
            + (f" transform_param {{ {tp} }}" if tp else "") + " }")
    specs, _, _ = net_from_prototxt(text, synthesize_data=False)
    want = {k: v[0] for k, v in parse_text(fields).items()}
    if "backend" in want:
        want["backend"] = "LMDB"
    if tp:
        want["transform_param"] = {
            k: list(v) if k == "mean_value" else v[0]
            for k, v in parse_text(tp).items()}
    assert specs[0].params == want
    if "batch_size" in want:
        specs, _, _ = net_from_prototxt(text, synthesize_data=False,
                                        batch=2)
        assert specs[0].params["batch_size"] == 2
