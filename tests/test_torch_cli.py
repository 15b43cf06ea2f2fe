"""The port's command line (``tools/cli.py``) against the JAX package's,
with ``--platform cpu``, on lenet and cifar10_quick, through each of its
seven subcommands:

* ``export_prototxt`` writes the JAX CLI's text (plain and ``--fuse``);
* ``export_caffemodel --weights <a JAX-written .npz>`` writes the JAX CLI's
  bytes;
* ``extract_features`` with the same ``--weights`` gives the JAX blobs
  within 1e-5 (cifar10_quick's up to its average pools, whose divisor is
  Caffe's in the port);
* ``draw_net`` writes the JAX CLI's DOT text;
* ``device_query``, ``test`` (dense and SCONV_PAR at 90%) and ``time``
  (its report has a row for every layer) run and exit 0;
* ``--platform auto`` on a machine without CUDA exits non-zero with a
  message, for every subcommand that takes it and for ``parity``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.engine.checkpoint import save_checkpoint  # noqa: E402
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.tools import cli as jcli  # noqa: E402

from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.tools import cli, parity  # noqa: E402

MODELS = ["lenet", "cifar10_quick"]
CPU = ["--platform", "cpu", "--batch", "2"]


def _jax_weights(model, path):
    """A JAX-written checkpoint of the model's params (seed 3)."""
    jnet = JNet(JZOO[model][0]())
    jparams = jnet.init(jax.random.PRNGKey(3),
                        {"data": (2,) + JZOO[model][1]["data"][1:]})
    save_checkpoint(path, jparams)
    return path + ".npz"


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_export_prototxt_is_the_jax_text(model, fuse, tmp_path):
    extra = ["--fuse"] if fuse else []
    args = ["export_prototxt", "--model", model, *CPU, *extra, "--output"]
    assert cli.main(args + [str(tmp_path / "t.prototxt")]) == 0
    jcli.main(args + [str(tmp_path / "j.prototxt")])
    assert (tmp_path / "t.prototxt").read_text() == \
        (tmp_path / "j.prototxt").read_text()


@pytest.mark.parametrize("model", MODELS)
def test_export_caffemodel_writes_the_jax_bytes(model, tmp_path):
    weights = _jax_weights(model, str(tmp_path / "w"))
    args = ["export_caffemodel", "--model", model, *CPU, "--weights",
            weights, "--output"]
    assert cli.main(args + [str(tmp_path / "t.caffemodel")]) == 0
    jcli.main(args + [str(tmp_path / "j.caffemodel")])
    assert (tmp_path / "t.caffemodel").read_bytes() == \
        (tmp_path / "j.caffemodel").read_bytes()


# cifar10_quick's blobs before its average pools, which take Caffe's
# divisor in the port and not the JAX package's
BLOBS = {"lenet": "ip2,prob", "cifar10_quick": "pool1r,conv2"}


@pytest.mark.parametrize("model", MODELS)
def test_extract_features_gives_the_jax_blobs(model, tmp_path):
    weights = _jax_weights(model, str(tmp_path / "w"))
    blobs = BLOBS[model]
    args = ["extract_features", "--model", model, *CPU, "--weights",
            weights, "--blobs", blobs, "--iterations", "2",
            "--sparsity", "0.9", "--output"]
    assert cli.main(args + [str(tmp_path / "t.npz")]) == 0
    assert jcli.main(args + [str(tmp_path / "j.npz")]) == 0
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) == sorted(blobs.split(","))
        for b in j.files:
            assert t[b].shape == j[b].shape and t[b].shape[0] == 4
            np.testing.assert_allclose(t[b], j[b], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", MODELS)
def test_draw_net_is_the_jax_dot(model, tmp_path):
    assert cli.main(["draw_net", "--model", model, "--output",
                     str(tmp_path / "t.dot")]) == 0
    jcli.main(["draw_net", "--model", model, "--output",
               str(tmp_path / "j.dot")])
    assert (tmp_path / "t.dot").read_text() == (tmp_path / "j.dot").read_text()


@pytest.mark.parametrize("model", MODELS)
def test_device_query_test_and_time_run(model, capsys):
    assert cli.main(["device_query", *CPU]) == 0
    assert "backend: cpu" in capsys.readouterr().out
    for mode in (["--conv_mode", "0"],
                 ["--conv_mode", "3", "--sparsity", "0.9"]):
        assert cli.main(["test", "--model", model, *CPU, "--iterations",
                         "2", *mode]) == 0
        out = capsys.readouterr().out
        assert "iteration 1: forward" in out and "average forward" in out
    assert cli.main(["time", "--model", model, *CPU, "--iterations", "1",
                     "--conv_mode", "3", "--sparsity", "0.9"]) == 0
    lines = capsys.readouterr().out.splitlines()
    names = [s.name for s in ZOO[model][0]()]
    start = next(i for i, ln in enumerate(lines) if ln.startswith("layer "))
    assert [ln.split()[0] for ln in lines[start + 1:start + 1 + len(names)]
            ] == names
    assert any(ln.startswith("[backward]") for ln in lines)


SUBCOMMANDS = ["device_query", "test", "time", "train", "export_prototxt",
               "export_caffemodel", "extract_features"]


@pytest.mark.parametrize("command", SUBCOMMANDS + ["parity"])
def test_platform_auto_without_cuda_fails(command, monkeypatch, capsys,
                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = {"export_prototxt": ["--output", str(tmp_path / "x")],
             "export_caffemodel": ["--output", str(tmp_path / "x")],
             "extract_features": ["--output", str(tmp_path / "x"),
                                  "--blobs", "prob"]}.get(command, [])
    if command == "parity":
        rc = parity.main(["--platform", "auto"])
    else:
        rc = cli.main([command, "--platform", "auto", *extra])
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("source", ["synthetic", "toy"])
def test_dataset_sources_are_the_jax_streams(source):
    """``data/datasets.py``: the same batches for the same seed."""
    from caffe_escoin_tpu.data import datasets as jds

    from caffe_escoin_tpu_torch.data import datasets as ds

    if source == "synthetic":
        args, kw = ((3, 8, 8, 2),), dict(num_classes=7, seed=5)
        got, want = (ds.synthetic_source(*args, **kw),
                     jds.synthetic_source(*args, **kw))
    else:
        got, want = (ds.classification_toy_source(4, 6, 3, seed=2),
                     jds.classification_toy_source(4, 6, 3, seed=2))
    for _ in range(3):
        a, b = got(), want()
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
