"""The port's dense-vs-sparse parity tool (``tools/parity.py``) against the
JAX package's, with ``--platform cpu``, on lenet with shared ``--weights``
(a JAX-written ``.npz`` checkpoint and a JAX-written ``.caffemodel``):
exit 0 under the default ``--tol``, the same three mode lines, and the
same top-1 agreement and top-5 overlap counts as the JAX tool. A
tolerance no mode can meet exits 1."""

import re

import pytest

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.engine.checkpoint import save_checkpoint  # noqa: E402
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.tools import parity as jparity  # noqa: E402
from caffe_escoin_tpu.tools.caffemodel import save_caffemodel  # noqa: E402

from caffe_escoin_tpu_torch.tools import parity  # noqa: E402

LINE = re.compile(r"^(\w+)\s*: max\|dprob\|=\S+ top1 agree (\d+)/(\d+) "
                  r"top5 overlap (\d+)/(\d+)\s+\[(OK|FAIL)\]$")


def _counts(out):
    """mode -> (top-1 agreed, total, top-5 overlap, of, status)."""
    got = {}
    for ln in out.splitlines():
        m = LINE.match(ln.strip())
        if m:
            got[m.group(1)] = m.groups()[1:]
    return got


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("lenet")
    jnet = JNet(JZOO["lenet"][0]())
    jparams = jnet.init(jax.random.PRNGKey(3), {"data": (4, 28, 28, 1)})
    save_checkpoint(str(d / "w"), jparams)
    save_caffemodel(jnet, jparams, str(d / "w.caffemodel"),
                    log=lambda *_: None)
    return {"npz": str(d / "w.npz"), "caffemodel": str(d / "w.caffemodel")}


@pytest.mark.parametrize("kind", ["npz", "caffemodel"])
def test_parity_counts_are_the_jax_counts(kind, weights, capsys):
    args = ["--model", "lenet", "--platform", "cpu", "--batch", "4",
            "--weights", weights[kind]]
    assert parity.main(args) == 0
    got = _counts(capsys.readouterr().out)
    assert jparity.main(args) == 0
    want = _counts(capsys.readouterr().out)
    assert set(got) == {"LOWERED_SPARSE", "SCONV", "SCONV_PAR"}
    assert got == want


def test_parity_fails_above_tol(weights, capsys):
    assert parity.main(["--model", "lenet", "--platform", "cpu", "--batch",
                        "4", "--weights", weights["npz"], "--tol",
                        "-1"]) == 1
    assert {c[-1] for c in _counts(capsys.readouterr().out).values()} == {
        "FAIL"}
