"""The port's example scripts (``caffe_escoin_tpu_torch/examples/``)
against the JAX package's (``examples/*.py``, loaded by path: the
directory has no ``__init__.py``), on the CPU, at small sizes:

* the digits file is scikit-learn's, and ``load_digits_upscaled`` gives
  the JAX arrays exactly;
* ``prune_params`` gives the JAX names and values exactly (LeNet and
  cifar10_bn, element-wise and 8x8 blocks, 70% and 90%);
* ``evaluate`` on carried params (and cifar10_bn's BatchNorm state),
  dense and aligned in SCONV_PAR: the same accuracy, logits within 1e-5
  relative L2;
* a masked fine-tune leg (5 steps of the example's ``.cerec`` stream) from
  carried weights, element-wise and 8x8 blocks: params within 1e-4
  relative L2, the same accuracies; a unit whose weights were all pruned
  keeps a zero bias (Caffe's ReLU gradient at 0, which the JAX package's
  ``jnp.maximum`` does not give);
* ``transplant_fc_to_conv`` and the full-conv CaffeNet (100 classes) at
  227x227: probabilities within 1e-5 of the JAX full-conv net's;
* ``siamese_net``'s specs, ``pair_iter``'s batches and the contrastive loss
  on carried params (1e-5 relative);
* every leg starts from the dense checkpoint, which no leg changes (the
  port's Solver updates in place), with a zero history;
* ``main`` end to end on LeNet, all three legs: the JAX script's rows and
  table columns; ``--report`` refuses the JAX package's records; without
  ``--platform cpu`` the entries need a card.
"""

import importlib.util
import json
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.data import datasets as jdatasets  # noqa: E402
from caffe_escoin_tpu.engine import context as jcontext  # noqa: E402
from caffe_escoin_tpu.engine.solver import Solver as JSolver  # noqa: E402
from caffe_escoin_tpu.engine.solvers import SolverConfig as JConfig  # noqa
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.utils.pruning import masks_of as jmasks_of  # noqa: E402

from caffe_escoin_tpu_torch.engine import context  # noqa: E402
from caffe_escoin_tpu_torch.examples import (digits, net_surgery,  # noqa: E402
                                             siamese_digits,
                                             train_eval_sparse)
from caffe_escoin_tpu_torch.examples.train_eval_sparse import (  # noqa: E402
    Experiment, clone, evaluate, prune_params)
from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.models.caffenet import caffenet  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net  # noqa: E402
from caffe_escoin_tpu_torch.nn.convert import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGITS_REL, PARAMS_REL, PROB_ABS, LOSS_REL = 1e-5, 1e-4, 1e-5, 1e-5
QUIET = dict(log=lambda *_: None)


def _jax_example(name):
    """``examples/<name>.py`` as a module (it puts the repository root on
    sys.path itself, so its ``from examples... import`` works)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTES = _jax_example("train_eval_sparse")
JSURGERY = _jax_example("net_surgery")
JSIAMESE = _jax_example("siamese_digits")


def _np(t):
    return np.asarray(t.detach().cpu() if hasattr(t, "detach") else t)


def _rel_l2(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _carried(model, shape, seed=0):
    """(JAX net, JAX params, the port's params, the port's BatchNorm
    state0) of one init of a ZOO model for inputs of ``shape``: the port's
    (a JAX init compiles for seconds), carried to JAX as arrays."""
    net = Net(ZOO[model][0](include_loss=True))
    params = net.init(torch.Generator().manual_seed(seed),
                      {"data": shape, "label": shape[:1]})
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     params)
    return (JNet(JZOO[model][0](include_loss=True), phase="test"), jparams,
            params, net.state0)


def _args(**kw):
    """The example's flags (its defaults), on the CPU."""
    args = train_eval_sparse.parse_args(["--platform", "cpu"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


# --------------------------------------------------------------- the data

def test_digits_file_is_scikit_learns():
    sk = pytest.importorskip("sklearn.datasets").load_digits()
    images, target = digits.load_digits()
    np.testing.assert_array_equal(images, sk.images)
    np.testing.assert_array_equal(target, sk.target)
    assert images.dtype == sk.images.dtype and images.shape == (1797, 8, 8)


@pytest.mark.parametrize("size,channels", [(28, 1), (32, 3)])
def test_load_digits_upscaled_matches_jax(size, channels):
    got = digits.load_digits_upscaled(size, channels)
    want = JTES.load_digits_upscaled(size, channels)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[1][0].shape == (256, size, size, channels)


# ------------------------------------------------------------ the pruning

@pytest.mark.parametrize("block", [None, (8, 8)], ids=["element", "block8"])
@pytest.mark.parametrize("sparsity", [0.7, 0.9])
@pytest.mark.parametrize("model,shape", [("lenet", (1, 28, 28, 1)),
                                         ("cifar10_bn", (1, 32, 32, 3))])
def test_prune_params_matches_jax(model, shape, sparsity, block):
    jnet, jparams, params, _ = _carried(model, shape)
    want, want_names = JTES.prune_params(jnet, jparams, sparsity, block)
    got, names = prune_params(Net(ZOO[model][0](include_loss=True)),
                              params, sparsity, block)
    assert names == want_names and names
    assert [k for k, _ in _leaves(got)] == [k for k, _ in _leaves(want)]
    for (k, g), (_, w) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=k)
    # the leaves it does not prune are the input's own tensors
    assert got["conv1"]["w"] is params["conv1"]["w"]


# ------------------------------------------------------------ the scoring

def _sp_policy(ctx):
    """The example's scoring policy from either package's
    ``engine.context``."""
    return ctx.ExecutionPolicy(conv_mode=ctx.ConvMode.SCONV_PAR,
                               block_shape=(8, 8), sparse_threshold=0.4,
                               sconv_threshold=0.4)


# cifar10_bn at 31x31: every average-pool window lies inside its map, where
# the port's divisor (Caffe's) and the JAX package's agree
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sconv_par"])
@pytest.mark.parametrize("model,size,channels,head", [
    ("lenet", 28, 1, "ip2"), ("cifar10_bn", 31, 3, "ip1")])
def test_evaluate_matches_jax(model, size, channels, head, sparse):
    """``evaluate`` (through ``Net.inference_fn`` with the BatchNorm
    state) on carried params and state, dense and aligned in SCONV_PAR."""
    _, (ted, tel) = digits.load_digits_upscaled(size, channels)
    ted, tel = ted[:128], tel[:128]
    jnet, jparams, params, state0 = _carried(model,
                                             (1, size, size, channels))
    # moving statistics of a net that has seen data (count 1)
    rng = np.random.default_rng(1)
    jstate = {n: {"mean_acc": jnp.asarray(rng.normal(
                  0, 0.1, b["mean_acc"].shape).astype(np.float32)),
                  "var_acc": jnp.asarray(rng.uniform(
                      0.5, 2, b["var_acc"].shape).astype(np.float32)),
                  "count": jnp.float32(1)}
              for n, b in state0.items()}
    assert bool(jstate) == (model == "cifar10_bn")
    state = params_from_jax({}, jstate)[1]
    specs = ZOO[model][0](include_loss=True)
    net = Net(specs, phase="test", device="cpu",
              policy=_sp_policy(context) if sparse else None)
    if sparse:
        jparams, _ = JTES.prune_params(jnet, jparams, 0.9, (8, 8))
        params = net.weight_align(params_from_jax(jparams)[0])
        jnet = JNet(JZOO[model][0](include_loss=True), phase="test",
                    policy=_sp_policy(jcontext))
        jparams = jnet.weight_align(jparams)
    acc = evaluate(net, params, state, ted, tel)
    assert acc == float(JTES.evaluate(jnet, jparams, jstate, ted, tel))
    logits = net.inference_fn(params, state=state, return_blobs=True)(
        {"data": torch.as_tensor(ted), "label": torch.as_tensor(tel)})[head]
    want = jnet.apply(jparams, {"data": jnp.asarray(ted),
                                "label": jnp.asarray(tel)},
                      state=jstate, return_blobs=True)[head]
    assert _rel_l2(logits, want) <= LOGITS_REL


# -------------------------------------------------------------- the legs

FT_STEPS, FT_BATCH = 5, 16


@pytest.mark.parametrize("gran,blk", [("unstructured", None),
                                      ("block", (8, 8))])
def test_masked_finetune_leg_matches_jax(tmp_path, gran, blk):
    """The port's one-shot leg (``Experiment.oneshot``: prune the
    checkpoint, masked fine-tune on the .cerec stream, score dense and
    aligned) against the JAX script's leg, both from the same carried
    checkpoint."""
    args = _args(batch=FT_BATCH, finetune_iters=FT_STEPS,
                 workdir=str(tmp_path / "port"))
    exp = Experiment(args, **QUIET)
    try:
        _, jparams, params, _ = _carried("lenet", (1, 28, 28, 1))
        exp.base_params, exp.base_state = params, {}
        row = exp.oneshot(gran, blk, 0.9)
    finally:
        exp.close()
    # the JAX script's leg (examples/train_eval_sparse.py:244-262)
    (trd, trl), (ted, tel) = JTES.load_digits_upscaled(28, 1)
    db = str(tmp_path / "jax.cerec")
    jdatasets.write_cerec(db, trd, trl.astype(np.float32))
    src = jdatasets.cerec_source(db, FT_BATCH)
    jspecs = JZOO["lenet"][0](num_classes=10, include_loss=True)
    jnet, jtest = JNet(jspecs, phase="train"), JNet(jspecs, phase="test")
    jsol = JSolver(jnet, JConfig(base_lr=args.base_lr, momentum=0.9,
                                 weight_decay=5e-4, lr_policy="inv",
                                 gamma=1e-4, power=0.75))
    jsol.init({"data": (FT_BATCH, 28, 28, 1), "label": (FT_BATCH,)})
    pruned, _ = JTES.prune_params(jnet, jparams, 0.9, blk)
    acc_pruned = JTES.evaluate(jtest, pruned, {}, ted, tel)
    jsol.params, jsol.net_state = pruned, {}
    jsol.state = jax.tree_util.tree_map(jnp.zeros_like, jsol.state)
    jsol.set_param_masks(jmasks_of(pruned))
    jsol.step(({k: jnp.asarray(v) for k, v in src().items()}
               for _ in range(FT_STEPS)), FT_STEPS, **QUIET)
    # 500 = 62 * 8 + 4: the 8x8 block pruning zeroes ip1's last, partial
    # block column, so those 4 units see a pre-activation of exactly 0.
    # Caffe's ReLU passes them no gradient (relu_layer.cpp: bottom_data >
    # 0), nor does the port's (torch.relu); jnp.maximum passes half, so
    # their JAX biases move. The port's stay 0; all else agrees.
    dead = np.flatnonzero(~np.asarray(pruned["ip1"]["w"]).any(axis=0))
    assert len(dead) == (4 if blk else 0)
    got = clone(exp.solver.params)
    want = jax.tree_util.tree_map(np.array, jsol.params)
    assert not got["ip1"]["b"][dead].any()
    if blk:
        assert np.asarray(want["ip1"]["b"])[dead].any()
    got["ip1"]["b"][dead] = 0
    want["ip1"]["b"][dead] = 0
    for (k, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert _rel_l2(g, w) <= PARAMS_REL, k
    acc_ft = JTES.evaluate(jtest, jsol.params, {}, ted, tel)
    sp_net = JNet(jspecs, phase="test",
                  policy=_sp_policy(jcontext))
    acc_sparse = JTES.evaluate(sp_net, sp_net.weight_align(jsol.params), {},
                               ted, tel)
    assert (row["acc_pruned"], row["acc_finetuned"],
            row["acc_sparse_exec"]) == (round(float(acc_pruned), 4),
                                        round(float(acc_ft), 4),
                                        round(float(acc_sparse), 4))


def _same(tree, ref):
    return all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_leaves(tree), _leaves(ref)))


def _shares(tree, ref):
    return any(a.data_ptr() == b.data_ptr() for (_, a), (_, b) in
               zip(_leaves(tree), _leaves(ref)))


def test_every_leg_starts_from_the_unchanged_dense_checkpoint(tmp_path):
    """The Solver updates in place: each leg must work on its own copy of
    the checkpoint, whose params and BatchNorm state stay bit-equal after
    every leg, and start from a zero solver history."""
    exp = Experiment(_args(model="cifar10_bn", batch=8, iters=3,
                           finetune_iters=2, gradual_iters=20,
                           base_lr=0.01, workdir=str(tmp_path)), **QUIET)
    try:
        exp.train_dense()
        params0, state0 = clone(exp.base_params), clone(exp.base_state)
        assert state0  # cifar10_bn's BatchNorm buffers
        legs = [lambda: exp.oneshot("unstructured", None, 0.9),
                lambda: exp.oneshot("block", (8, 8), 0.9),
                lambda: exp.gradual(0.9), lambda: exp.deploy(0.9)]
        for leg in legs:
            leg()
            assert _same(exp.base_params, params0)
            assert _same(exp.base_state, state0)
            assert not _shares(exp.solver.params, exp.base_params)
            assert not _shares(exp.solver.net_state, exp.base_state)
        exp._restart(clone(exp.base_params), None)
        assert all(not bool(t.any()) for _, t in _leaves(exp.solver.state))
    finally:
        exp.close()
    assert not (tmp_path / "train.cerec").exists()


MAIN_FLAGS = ["--iters", "4", "--finetune_iters", "2", "--sparsities",
              "0.9", "--gradual_iters", "20", "--batch", "16"]


def test_main_end_to_end_gives_the_jax_rows_and_columns(tmp_path, capsys,
                                                        monkeypatch):
    port, jaxr = tmp_path / "port.md", tmp_path / "jax.md"
    assert train_eval_sparse.main(MAIN_FLAGS + [
        "--platform", "cpu", "--report", str(port)]) == 0
    got_md = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["train_eval_sparse.py", *MAIN_FLAGS,
                                     "--report", str(jaxr), "--workdir",
                                     str(tmp_path / "jax")])
    JTES.main()
    want_md = capsys.readouterr().out
    got, want = (json.loads(p.with_suffix(".md.json").read_text())
                 for p in (port, jaxr))
    assert sorted(got) == sorted(want)
    assert [sorted(r) for r in got["rows"]] == [sorted(r)
                                                for r in want["rows"]]
    assert ([(r["granularity"], r["target_sparsity"]) for r in got["rows"]]
            == [(r["granularity"], r["target_sparsity"])
                for r in want["rows"]]
            == [("unstructured", 0.9), ("block", 0.9),
                ("block_gradual", 0.9)])
    dep, jdep = got["unstructured_deployment"], want["unstructured_deployment"]
    assert sorted(dep) == sorted(jdep)
    assert sorted(dep["per_layer"]) == sorted(jdep["per_layer"])
    for r in got["rows"]:
        assert abs(r["achieved_sparsity"] - r["target_sparsity"]) <= 0.01
    got_lines, want_lines = got_md.splitlines(), want_md.splitlines()
    assert got_lines[2:4] == want_lines[2:4]  # header and rule
    assert ([ln.count("|") for ln in got_lines]
            == [ln.count("|") for ln in want_lines])
    assert port.read_text() == got_md + "\n"  # print adds one newline


@pytest.mark.parametrize("name", ["EXPERIMENTS.md", "EXPERIMENTS_alexnet.md",
                                  "EXPERIMENTS.md.json"])
def test_report_refuses_the_jax_records(name, capsys):
    record = ROOT / "docs" / name
    before = record.read_bytes()
    assert train_eval_sparse.main(["--platform", "cpu", "--report",
                                   str(record)]) == 2
    assert "JAX package's record" in capsys.readouterr().err
    assert record.read_bytes() == before


@pytest.mark.parametrize("mod", [train_eval_sparse, net_surgery,
                                 siamese_digits],
                         ids=["train_eval_sparse", "net_surgery",
                              "siamese_digits"])
def test_entries_need_the_card_unless_the_cpu_is_asked_for(mod, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert mod.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(Namespace(platform="auto") if mod is not net_surgery
                else "auto")


# ----------------------------------------------------------- net surgery

def test_net_surgery_full_conv_caffenet_matches_jax():
    """Both packages on one classifier's weights (the port's init, which
    takes a second where the JAX one takes seven)."""
    shape = {"data": (1, 227, 227, 3)}
    params = Net(caffenet(num_classes=100)).init(
        torch.Generator().manual_seed(0), shape)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     params)
    jfc = JNet(JSURGERY.fullconv_specs(num_classes=100), phase="test")
    # the JAX script's surgery (examples/net_surgery.py:72-84), which
    # replaces every param of its full-conv net's init
    jfparams = {}
    for src, dst, k, cin in net_surgery.FC_TO_CONV:
        cw, cb = JSURGERY.transplant_fc_to_conv(
            np.asarray(jparams[src]["w"]), np.asarray(jparams[src]["b"]), k,
            cin)
        jfparams[dst] = dict(w=jnp.asarray(cw), b=jnp.asarray(cb))
        got_w, got_b = net_surgery.transplant_fc_to_conv(
            torch.tensor(np.asarray(jparams[src]["w"])),
            torch.tensor(np.asarray(jparams[src]["b"])), k, cin)
        np.testing.assert_array_equal(_np(got_w), cw)
        np.testing.assert_array_equal(_np(got_b), cb)
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5"):
        jfparams[name] = jparams[name]
    x = np.random.default_rng(0).standard_normal(
        (1, 227, 227, 3)).astype(np.float32) * 0.1
    want = np.asarray(jfc.apply(jfparams, {"data": jnp.asarray(x)})["prob"])

    fc_net = Net(net_surgery.fullconv_specs(num_classes=100), phase="test")
    fparams = net_surgery.surgery(
        params, fc_net.init(torch.Generator().manual_seed(1), shape),
        **QUIET)
    assert sorted(fparams) == sorted(jfparams)
    got = fc_net.inference_fn(fparams)({"data": torch.as_tensor(x)})["prob"]
    assert got.shape == want.shape == (1, 1, 1, 100)
    assert float(np.abs(_np(got) - want).max()) <= PROB_ABS


def test_net_surgery_runs_on_the_cpu(capsys):
    assert net_surgery.main(["--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("net_surgery: parity_err ") and "map 8x8x100" in out


# --------------------------------------------------------------- siamese

def test_siamese_specs_match_jax():
    got, want = siamese_digits.siamese_net(), JSIAMESE.siamese_net()
    assert [(s.name, s.type, s.bottoms, s.tops, s.params, s.share_params)
            for s in got] == [(s.name, s.type, s.bottoms, s.tops, s.params,
                               s.share_params) for s in want]
    assert [s.share_params for s in got if s.share_params] == [
        "conv1", "conv2", "ip1", "feat"]


def test_pair_iter_matches_jax():
    (trd, trl), _ = digits.load_digits_upscaled(28, 1)
    got = siamese_digits.pair_iter(trd, trl, 16)
    want = JSIAMESE.pair_iter(trd, trl, 16)
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_contrastive_loss_on_carried_params_matches_jax():
    (trd, trl), _ = digits.load_digits_upscaled(28, 1)
    shapes = {"data": (16, 28, 28, 1), "data_p": (16, 28, 28, 1),
              "sim": (16,)}
    jnet = JNet(JSIAMESE.siamese_net(), phase="train")
    jparams = jnet.init(jax.random.PRNGKey(0), shapes)
    assert "conv1_p" not in jparams
    batch = next(siamese_digits.pair_iter(trd, trl, 16))
    want = float(jnet.loss(jparams, {k: jnp.asarray(v)
                                     for k, v in batch.items()}))
    net = Net(siamese_digits.siamese_net(), phase="train", device="cpu")
    got = float(net.loss(params_from_jax(jparams)[0],
                         {k: torch.as_tensor(v) for k, v in batch.items()}))
    assert got == pytest.approx(want, rel=LOSS_REL)
    assert want > 0


def test_siamese_separates_the_classes_on_the_cpu():
    r = siamese_digits.run(Namespace(iters=100, batch=32, base_lr=0.02,
                                     platform="cpu"), **QUIET)
    assert r["neg"] > r["pos"] and 0.5 < r["pair_acc"] <= 1.0
    assert "conv1_p" not in r["solver"].params
