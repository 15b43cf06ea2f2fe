"""The data slice against the JAX package: the transformer, ``.cerec``
files, LMDB files and the two data commands of the command line.

* Transformer: TEST (mean image or values, scale, center crop) equals the
  JAX output exactly; TRAIN draws its crop and mirror per image (Caffe's
  rule, where the JAX transformer draws once per batch), held to its
  properties: every image is a window of its own source, flipped or not,
  and both offsets and coins vary within one batch.
* ``.cerec`` and LMDB: the two packages write the same bytes for the same
  data, and each reads the other's files (the cases of
  tests/test_lmdb_io.py, run on the port's module, and its data layer).
* ``convert_imageset`` (cerec and lmdb, shuffled, gray, resized) and
  ``compute_image_mean`` write the JAX command line's bytes.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.data import datasets as jdatasets  # noqa: E402
from caffe_escoin_tpu.data import lmdb_io as jlmdb  # noqa: E402
from caffe_escoin_tpu.data.transformer import \
    DataTransformer as JTransformer  # noqa: E402
from caffe_escoin_tpu.data.transformer import \
    TransformParams as JParams  # noqa: E402

from caffe_escoin_tpu_torch.data import datasets, lmdb_io  # noqa: E402
from caffe_escoin_tpu_torch.data.transformer import (  # noqa: E402
    DataTransformer, TransformParams)


# ---------------------------------------------------------------- transformer

def _images(n=6, h=10, w=12, c=3, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, h, w, c)).astype(np.uint8)


TEST_CASES = [
    dict(crop_size=6),
    dict(crop_size=7, scale=0.5, mean_value=(10.0, 20.0, 30.0)),
    dict(crop_size=8, mean_image="image", scale=1 / 255.0),
    dict(mean_value=(128.0, 128.0, 128.0)),
    dict(),
]


@pytest.mark.parametrize("kw", TEST_CASES, ids=lambda kw: "-".join(kw) or
                         "identity")
def test_transformer_test_phase_is_the_jax_output(kw):
    x = _images()
    kw = dict(kw)
    if kw.get("mean_image") == "image":
        kw["mean_image"] = np.random.default_rng(1).uniform(
            0, 255, x.shape[1:]).astype(np.float32)
    want = JTransformer(JParams(phase="test", mirror=True, **kw))(
        {"data": x, "label": np.arange(6)})
    got = DataTransformer(TransformParams(phase="test", mirror=True, **kw))(
        {"data": x, "label": np.arange(6)})
    assert got["data"].dtype == np.float32 and got["data"].flags.c_contiguous
    np.testing.assert_array_equal(got["data"], want["data"])
    np.testing.assert_array_equal(got["label"], np.arange(6))


def test_transformer_train_crops_and_mirrors_per_image():
    """Each image is some window of its own source (mean-subtracted,
    scaled), flipped or not; over a batch of 64 both the offsets and the
    flips vary, which a per-batch draw cannot give."""
    x = _images(n=64, h=9, w=9)
    mean = np.asarray((5.0, 6.0, 7.0), np.float32)
    tr = DataTransformer(TransformParams(crop_size=5, mirror=True,
                                         scale=0.5, mean_value=tuple(mean),
                                         phase="train"), seed=3)
    out = tr({"data": x})["data"]
    assert out.shape == (64, 5, 5, 3) and out.dtype == np.float32
    full = (x.astype(np.float32) - mean) * np.float32(0.5)
    picks = set()
    for i in range(64):
        found = [(oy, ox, flip) for oy in range(5) for ox in range(5)
                 for flip in (False, True)
                 if np.array_equal(out[i], (lambda w: w[:, ::-1] if flip
                                            else w)(full[i, oy:oy + 5,
                                                         ox:ox + 5]))]
        assert found, i
        picks.add(found[0])
    assert len({p[:2] for p in picks}) > 4
    assert {p[2] for p in picks} == {False, True}
    # the same seed draws the same batch
    again = DataTransformer(TransformParams(
        crop_size=5, mirror=True, scale=0.5, mean_value=tuple(mean),
        phase="train"), seed=3)({"data": x})["data"]
    np.testing.assert_array_equal(again, out)


def test_transformer_train_mirror_only_keeps_the_size():
    x = _images(n=32)
    out = DataTransformer(TransformParams(mirror=True, phase="train"))(
        {"data": x})["data"]
    flipped = [np.array_equal(out[i], x[i, :, ::-1].astype(np.float32))
               for i in range(32)]
    same = [np.array_equal(out[i], x[i].astype(np.float32))
            for i in range(32)]
    assert all(f or s for f, s in zip(flipped, same))
    assert any(flipped) and any(same)


# ---------------------------------------------------------------- .cerec

def test_cerec_bytes_and_cross_reads(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((7, 4, 5, 3)).astype(np.float32)
    labels = rng.integers(0, 9, 7)
    mine, theirs = tmp_path / "port.cerec", tmp_path / "jax.cerec"
    datasets.write_cerec(str(mine), data, labels)
    jdatasets.write_cerec(str(theirs), data, labels)
    assert mine.read_bytes() == theirs.read_bytes()
    assert datasets.read_cerec_header(str(theirs)) == \
        jdatasets.read_cerec_header(str(mine))
    for loop in (True, False):
        a = datasets.cerec_source(str(theirs), 3, loop=loop)
        b = jdatasets.cerec_source(str(mine), 3, loop=loop)
        for _ in range(2):
            x, y = a(), b()
            assert x["label"].dtype == y["label"].dtype == np.int32
            np.testing.assert_array_equal(x["data"], y["data"])
            np.testing.assert_array_equal(x["label"], y["label"])
        if loop:
            np.testing.assert_array_equal(a()["label"],
                                          labels[[6, 0, 1]])
        else:
            with pytest.raises(StopIteration):
                a()
    (tmp_path / "bad").write_bytes(b"XXXX" * 8)
    with pytest.raises(ValueError, match="not a cerec"):
        datasets.read_cerec_header(str(tmp_path / "bad"))


# ---------------------------------------------------------------- LMDB

def _mk(tmp_path, items, psize=4096, mod=lmdb_io, name="db"):
    p = str(tmp_path / name)
    os.makedirs(p, exist_ok=True)
    mod.write_lmdb(p, items, psize=psize)
    return p


def _items_big(rng):
    items = [(b"%08d" % i, rng.bytes(40)) for i in range(200)]
    items.append((b"big-0001", rng.bytes(9000)))  # an overflow run
    items.append((b"big-0002", rng.bytes(5000)))
    return items


@pytest.mark.parametrize("case", ["small", "multi_leaf_overflow", "psize"])
def test_lmdb_bytes_and_cross_reads(tmp_path, case):
    """The cases of tests/test_lmdb_io.py: each package's writer gives the
    same file, and each reader reads the other's."""
    rng = np.random.default_rng(0)
    items, psize = {
        "small": ([(b"%08d" % i, b"value-%d" % i) for i in range(10)], 4096),
        "multi_leaf_overflow": (_items_big(rng), 4096),
        "psize": ([(b"a", b"1"), (b"b", b"2")], 8192),
    }[case]
    mine = _mk(tmp_path, items, psize, lmdb_io, "port")
    theirs = _mk(tmp_path, items, psize, jlmdb, "jax")
    with open(os.path.join(mine, "data.mdb"), "rb") as a, \
            open(os.path.join(theirs, "data.mdb"), "rb") as b:
        assert a.read() == b.read()
    for rd in (lmdb_io.LmdbReader(theirs), jlmdb.LmdbReader(mine)):
        assert len(rd) == len(items) and rd.psize == psize
        got = list(rd.items())
        assert got == sorted(items)


def test_lmdb_datum_codec_matches():
    rng = np.random.default_rng(1)
    img8 = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    imgf = rng.standard_normal((4, 4, 1)).astype(np.float32)
    for img, label in ((img8, 7), (imgf, 2)):
        raw = lmdb_io.datum_encode(img, label=label)
        assert raw == jlmdb.datum_encode(img, label=label)
        arr, lb = lmdb_io.datum_decode(raw)
        assert lb == label and arr.dtype == img.dtype
        np.testing.assert_array_equal(arr, img)


def test_lmdb_source_batches_wrap(tmp_path):
    rng = np.random.default_rng(2)
    items = [(b"%08d" % i, lmdb_io.datum_encode(
        rng.integers(0, 256, (8, 8, 3), dtype=np.uint8), label=i % 3))
        for i in range(7)]
    p = _mk(tmp_path, items)
    src, jsrc = lmdb_io.lmdb_source(p, batch=4), jlmdb.lmdb_source(p, 4)
    for want in ([0, 1, 2, 0], [1, 2, 0, 0]):
        a, b = src(), jsrc()
        assert a["label"].tolist() == want and a["label"].dtype == np.int64
        assert a["data"].shape == (4, 8, 8, 3) and a["data"].dtype == \
            np.float32
        np.testing.assert_array_equal(a["data"], b["data"])


def test_lmdb_rejects_non_lmdb(tmp_path):
    f = tmp_path / "x.mdb"
    f.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="magic|not an LMDB"):
        lmdb_io.LmdbReader(str(f))


# ---------------------------------------------------------------- CLI

@pytest.fixture
def image_list(tmp_path):
    """Nine PNGs of two sizes and their "<path> <label>" list."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(9):
        h, w = (10, 12) if i % 2 else (9, 7)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(tmp_path / f"im{i}.png")
        lines.append(f"im{i}.png {i % 4}\n")
    (tmp_path / "list.txt").write_text("".join(lines))
    return tmp_path


CONVERT = [
    ("cerec", ["--resize-height", "8", "--resize-width", "8"]),
    ("cerec", ["--resize-height", "6", "--resize-width", "5", "--shuffle",
               "--seed", "3", "--gray"]),
    ("lmdb", ["--resize-height", "8", "--resize-width", "8"]),
    ("lmdb", ["--resize-height", "7", "--resize-width", "9", "--shuffle"]),
]


@pytest.mark.parametrize("backend,flags", CONVERT,
                         ids=["cerec", "cerec_gray_shuffled", "lmdb",
                              "lmdb_shuffled"])
def test_convert_imageset_matches_the_jax_cli(image_list, backend, flags,
                                              capsys):
    from caffe_escoin_tpu.tools import cli as jcli

    from caffe_escoin_tpu_torch.tools import cli

    outs = []
    for mod, name in ((cli, "port"), (jcli, "jax")):
        out = str(image_list / f"{name}.{backend}")
        if backend == "lmdb":
            os.makedirs(out)
        argv = ["convert_imageset", str(image_list / "list.txt"), out,
                "--root-folder", str(image_list), "--backend", backend,
                *flags]
        assert mod.main(argv) == 0
        outs.append(out)
    if backend == "lmdb":
        outs = [os.path.join(o, "data.mdb") for o in outs]
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()
    assert "wrote 9 records" in capsys.readouterr().out


def test_convert_imageset_lmdb_pixels_read_back(image_list):
    """The LMDB holds each PNG's pixels as they are (float Datum values,
    as the JAX command line writes them)."""
    from PIL import Image

    from caffe_escoin_tpu_torch.tools import cli

    out = str(image_list / "db")
    os.makedirs(out)
    lines = [f"im{i}.png {i}\n" for i in (1, 3, 5)]  # all 10x12
    (image_list / "same.txt").write_text("".join(lines))
    assert cli.main(["convert_imageset", str(image_list / "same.txt"), out,
                     "--root-folder", str(image_list), "--backend",
                     "lmdb"]) == 0
    for (key, raw), i in zip(lmdb_io.LmdbReader(out).items(), (1, 3, 5)):
        arr, label = lmdb_io.datum_decode(raw)
        assert label == i
        np.testing.assert_array_equal(
            arr, np.asarray(Image.open(image_list / f"im{i}.png"),
                            np.float32))


def test_compute_image_mean_matches_the_jax_cli(tmp_path):
    from caffe_escoin_tpu.tools import cli as jcli

    from caffe_escoin_tpu_torch.tools import cli

    rng = np.random.default_rng(0)
    src = str(tmp_path / "d.cerec")
    datasets.write_cerec(src, rng.uniform(0, 255, (70, 5, 6, 3)),
                         np.zeros(70))
    assert cli.main(["compute_image_mean", src,
                     str(tmp_path / "port.npy")]) == 0
    assert jcli.main(["compute_image_mean", src,
                      str(tmp_path / "jax.npy")]) == 0
    assert (tmp_path / "port.npy").read_bytes() == \
        (tmp_path / "jax.npy").read_bytes()
    mean = np.load(tmp_path / "port.npy")
    assert mean.shape == (5, 6, 3) and mean.dtype == np.float32


def test_lmdb_source_without_loop_ends(tmp_path):
    """``loop=False`` gives the JAX source's short last batch, then stops."""
    items = [(b"%08d" % i, lmdb_io.datum_encode(
        np.full((2, 2, 1), i, np.uint8), label=i)) for i in range(5)]
    p = _mk(tmp_path, items)
    src = lmdb_io.lmdb_source(p, 2, loop=False)
    jsrc = jlmdb.lmdb_source(p, 2, loop=False)
    for _ in range(3):
        a, b = src(), jsrc()
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["data"], b["data"])
    assert a["label"].tolist() == [4]
    with pytest.raises(StopIteration):
        src()
    empty = _mk(tmp_path, [], name="empty")
    with pytest.raises(ValueError, match="empty"):
        lmdb_io.lmdb_source(empty, 2)
