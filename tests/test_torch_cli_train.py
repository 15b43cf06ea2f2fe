"""``tools/cli.py train`` against the JAX package's, with ``--platform
cpu``: both run lenet from the same JAX-written ``--weights`` checkpoint (a
JAX Solver's snapshot at iteration 2: params and SGD history) on the same
synthetic batches, and their final snapshots agree to rtol 1e-4, atol 1e-6
(a few f32 steps; the convs sum in another order on each side). Once with
the solver flags, once with ``--solver x.prototxt`` whose ``net`` names a
lenet train prototxt.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.engine.checkpoint import (  # noqa: E402
    load_checkpoint_full as jload)
from caffe_escoin_tpu.engine.solver import Solver as JSolver  # noqa: E402
from caffe_escoin_tpu.engine.solvers import (  # noqa: E402
    SolverConfig as JConfig)
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.tools import cli as jcli  # noqa: E402

from caffe_escoin_tpu_torch.engine.checkpoint import (  # noqa: E402
    load_checkpoint_full)
from caffe_escoin_tpu_torch.engine.solvers import SolverConfig  # noqa: E402
from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.tools import cli  # noqa: E402
from caffe_escoin_tpu_torch.tools.prototxt import (  # noqa: E402
    net_to_prototxt, solver_to_prototxt)

BATCH = 4


def _jax_snapshot(tmp_path):
    """A JAX Solver's snapshot of lenet after 2 SGD iterations."""
    shapes = {"data": (BATCH, 28, 28, 1), "label": (BATCH,)}
    sol = JSolver(JNet(JZOO["lenet"][0](include_loss=True), phase="train"),
                  JConfig(base_lr=0.01, momentum=0.9), display=0,
                  snapshot_prefix=str(tmp_path / "start"))
    sol.init(shapes)
    rng = np.random.default_rng(9)
    batch = {"data": rng.standard_normal(shapes["data"]).astype(np.float32),
             "label": rng.integers(0, 10, BATCH).astype(np.int32)}
    sol.step(iter([batch] * 2), 2, log=lambda *_: None)
    return sol.snapshot() + ".npz"


def _close(tree, jtree):
    assert sorted(tree) == sorted(jtree)
    for k, v in jtree.items():
        if isinstance(v, dict):
            _close(tree[k], v)
        else:
            np.testing.assert_allclose(tree[k].numpy(), v, rtol=1e-4,
                                       atol=1e-6)


def _agree(path, jpath):
    params, state, _, meta = load_checkpoint_full(path)
    jparams, jstate, _, jmeta = jload(jpath)
    assert meta == jmeta
    _close(params, jparams)
    _close(state, jstate)


def test_cli_train_from_jax_weights_matches_jax(tmp_path, capsys):
    weights = _jax_snapshot(tmp_path)
    common = ["train", "--model", "lenet", "--platform", "cpu", "--batch",
              str(BATCH), "--iterations", "4", "--weights", weights,
              "--weight-decay", "5e-4", "--lr-policy", "step",
              "--step-size", "3", "--display", "1"]
    assert cli.main(common + ["--snapshot-prefix", str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out
    assert "Iteration 2, lr = 0.01," in out and "done at iteration 6" in out
    assert jcli.main(common + ["--snapshot-prefix",
                               str(tmp_path / "j")]) == 0
    _agree(str(tmp_path / "t_iter_6"), str(tmp_path / "j_iter_6"))


def test_cli_train_with_a_solver_prototxt_matches_jax(tmp_path):
    weights = _jax_snapshot(tmp_path)
    net_path = tmp_path / "lenet_train.prototxt"
    net_path.write_text(net_to_prototxt(
        ZOO["lenet"][0](include_loss=True),
        {"data": (BATCH, 28, 28, 1), "label": (BATCH,)}, name="LeNet"))
    cfg = SolverConfig(solver_type="nesterov", base_lr=0.02, momentum=0.8,
                       weight_decay=1e-3, lr_policy="step", gamma=0.5,
                       step_size=3)
    for tag in ("t", "j"):
        (tmp_path / f"{tag}_solver.prototxt").write_text(solver_to_prototxt(
            cfg, {"net": str(net_path), "display": 1,
                  "snapshot_prefix": str(tmp_path / tag)}))
    for tag, main in (("t", cli.main), ("j", jcli.main)):
        assert main(["train", "--solver",
                     str(tmp_path / f"{tag}_solver.prototxt"),
                     "--platform", "cpu", "--batch", str(BATCH),
                     "--iterations", "3", "--weights", weights]) == 0
    _agree(str(tmp_path / "t_iter_5"), str(tmp_path / "j_iter_5"))
