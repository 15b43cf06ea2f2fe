"""The port's training loop (``engine/solver.Solver``) against the JAX
package's, started from the same params, solver state and BatchNorm state
(carried over by ``nn.convert``) on the same numpy batches:

* lenet, SGD, iter_size 2;
* cifar10_bn (BatchNorm in training mode), Adam, weight decay, clipping;
* a narrow AlexNet-shaped net (LRN, grouped conv, fc, Dropout at ratio 0)
  under a block-granular pruning schedule (4x4 blocks, recomputed every
  iteration): the masks must be equal on both sides.

Losses per step, params, solver state and BatchNorm state after the run
agree to rtol 1e-4 (a few f32 steps; the convs sum in another order on
each side), the masks exactly. Also: checkpoints load across packages in
both directions, SIGHUP snapshots and SIGINT stops, the RSS guard stops and
snapshots and a bad $CESCOIN_RSS_LIMIT_GB raises, the default device is the
card (none here: it raises), every solver reduces a least-squares loss,
and the training half of ``utils/pruning.py`` and ``data/pipeline.py``.
"""

import os
import signal

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.data import pipeline as jpipeline  # noqa: E402
from caffe_escoin_tpu.engine import solvers as jsolvers  # noqa: E402
from caffe_escoin_tpu.engine.solver import Solver as JSolver  # noqa: E402
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.utils import pruning as jpruning  # noqa: E402

from caffe_escoin_tpu_torch.data.pipeline import PrefetchLoader  # noqa: E402
from caffe_escoin_tpu_torch.engine import solver as solver_mod  # noqa: E402
from caffe_escoin_tpu_torch.engine import solvers  # noqa: E402
from caffe_escoin_tpu_torch.engine.solver import Solver  # noqa: E402
from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.nn import LayerSpec, Net  # noqa: E402
from caffe_escoin_tpu_torch.nn.convert import (params_from_jax,  # noqa: E402
                                               solver_state_from_jax)
from caffe_escoin_tpu_torch.utils import pruning  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
QUIET = dict(log=lambda *_: None)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if hasattr(tree, "detach")
                      else tree)


def _close(got, want, rtol=RTOL, atol=ATOL, exact=False):
    got, want = _np(got), _np(want)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], rtol, atol, exact)
        elif exact:
            np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       atol=atol, err_msg=k)


def _pair(specs, jspecs, shapes, cfg_kw, **kw):
    """A JAX Solver and a port Solver (CPU) from the same start."""
    jsol = JSolver(JNet(jspecs, phase="train"),
                   jsolvers.SolverConfig(**cfg_kw), display=0, **kw)
    jsol.init(shapes)
    sol = Solver(Net(specs, phase="train"), solvers.SolverConfig(**cfg_kw),
                 display=0, device="cpu", **kw)
    sol.init(shapes)
    sol.params, sol.net_state = params_from_jax(jsol.params, jsol.net_state)
    sol.state = solver_state_from_jax(jsol.state)
    return jsol, sol


def _batches(shapes, n, num_classes, seed=0):
    rng = np.random.default_rng(seed)
    return [{"data": rng.standard_normal(shapes["data"]).astype(np.float32),
             "label": rng.integers(0, num_classes, shapes["data"][0]
                                   ).astype(np.int32)} for _ in range(n)]


def _run_both(jsol, sol, batches, iters, param_atol=ATOL):
    per = len(batches) // iters
    losses = []
    for i in range(iters):
        chunk = batches[i * per:(i + 1) * per]
        jsol.step(iter(chunk), 1, **QUIET)
        sol.step(iter(chunk), 1, **QUIET)
        losses.append((sol._losses[-1], jsol._losses[-1]))
    got, want = np.array(losses).T
    np.testing.assert_allclose(got, want, rtol=RTOL)
    _close(sol.params, jsol.params, atol=param_atol)
    _close(sol.state, jsol.state)
    _close(sol.net_state, jsol.net_state)
    assert sol.iter == jsol.iter == iters


def test_lenet_sgd_iter_size_2_matches_jax():
    shapes = {"data": (4, 28, 28, 1), "label": (4,)}
    cfg = dict(solver_type="sgd", base_lr=0.01, momentum=0.9, iter_size=2,
               weight_decay=5e-4, lr_policy="step", gamma=0.5, step_size=2)
    jsol, sol = _pair(ZOO["lenet"][0](include_loss=True),
                      JZOO["lenet"][0](include_loss=True), shapes, cfg)
    _run_both(jsol, sol, _batches(shapes, 8, 10), 4)


# cifar10_bn at 31x31: every average-pool window lies inside its map (15,
# 7, 3 outputs), where the port's divisor (Caffe's, clipped at the map's
# edge) and the JAX package's (kh*kw) agree; at 32x32 the ceil-extended
# last windows would differ by design
CIFAR_BN = {"data": (8, 31, 31, 3), "label": (8,)}
# a conv's bias before BatchNorm has a zero gradient in exact arithmetic
# (BatchNorm subtracts the batch mean), so on each side it is rounding
# noise that Adam scales to a step of +-lr: those three biases are frozen
# (lr_mult 0) on both sides, as Caffe's BatchNorm nets drop the conv bias
CIFAR_BN_MULTS = {
    **{f"conv{i}": {"w": 1.0, "b": 0.0} for i in (1, 2, 3)},
    **{f"scale{i}": {"gamma": 1.0, "beta": 1.0} for i in (1, 2, 3)},
    "ip1": {"w": 1.0, "b": 1.0}}
# Adam divides each step by sqrt(v): where a weight's gradient is near
# zero its step of lr = 1e-3 is a ratio of two rounding-level numbers, so
# the params agree to 2% of a step (atol 2e-5) after it
ADAM_ATOL = 2e-5


def test_cifar10_bn_adam_batchnorm_training_matches_jax():
    """BatchNorm normalizes by batch statistics and its moving sums advance
    on both sides; Adam with weight decay and gradient clipping."""
    shapes = CIFAR_BN
    cfg = dict(solver_type="adam", base_lr=1e-3, weight_decay=5e-3,
               clip_gradients=1.0)
    jsol, sol = _pair(ZOO["cifar10_bn"][0](include_loss=True),
                      JZOO["cifar10_bn"][0](include_loss=True), shapes, cfg,
                      lr_mults=CIFAR_BN_MULTS)
    _run_both(jsol, sol, _batches(shapes, 3, 10, seed=1), 3,
              param_atol=ADAM_ATOL)
    assert float(sol.net_state["bn1"]["count"]) > 2.9
    # the trained net scored on the test phase: the same accuracy and loss
    test_specs = ZOO["cifar10_bn"][0](include_loss=True)
    sol.test_net = Net(test_specs, phase="test")
    jsol.test_net = JNet(JZOO["cifar10_bn"][0](include_loss=True),
                         phase="test")
    test = _batches(shapes, 2, 10, seed=2)
    sol.test_iters = jsol.test_iters = 2
    got = sol.test_all(iter(test), **QUIET)
    want = jsol.test_all(iter(test), **QUIET)
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)


def _narrow_alexnet(spec_cls):
    def conv(name, bottom, cout, k, s=1, p=0, group=1):
        return spec_cls(name, "ConvolutionReLU", (bottom,),
                        params=dict(num_output=cout, kernel=k, stride=s,
                                    pad=p, group=group))

    return [
        conv("conv1", "data", 8, 5, s=2),
        spec_cls("norm1", "LRN", ("conv1",),
                 params=dict(local_size=5, alpha=1e-4, beta=0.75)),
        spec_cls("pool1", "Pooling", ("norm1",),
                 params=dict(kernel=3, stride=2)),
        conv("conv2", "pool1", 16, 3, p=1, group=2),
        spec_cls("norm2", "LRN", ("conv2",),
                 params=dict(local_size=5, alpha=1e-4, beta=0.75)),
        spec_cls("pool2", "Pooling", ("norm2",),
                 params=dict(kernel=3, stride=2)),
        conv("conv3", "pool2", 16, 3, p=1),
        spec_cls("fc6", "InnerProduct", ("conv3",),
                 params=dict(num_output=32)),
        spec_cls("relu6", "ReLU", ("fc6",), tops=("fc6r",)),
        spec_cls("drop6", "Dropout", ("fc6r",), tops=("fc6d",),
                 params=dict(ratio=0.0)),
        spec_cls("fc7", "InnerProduct", ("fc6d",),
                 params=dict(num_output=32)),
        spec_cls("relu7", "ReLU", ("fc7",), tops=("fc7r",)),
        spec_cls("drop7", "Dropout", ("fc7r",), tops=("fc7d",),
                 params=dict(ratio=0.0)),
        spec_cls("fc8", "InnerProduct", ("fc7d",),
                 params=dict(num_output=10)),
        spec_cls("loss", "SoftmaxWithLoss", ("fc8", "label")),
    ]


def test_narrow_alexnet_under_a_pruning_schedule_matches_jax():
    """AGP block pruning (4x4 blocks, every iteration up to iteration 4):
    the same masks, recomputed from the same weights, on both sides."""
    shapes = {"data": (4, 35, 35, 3), "label": (4,)}
    cfg = dict(solver_type="sgd", base_lr=0.01, momentum=0.9,
               weight_decay=5e-4)
    jsol, sol = _pair(_narrow_alexnet(LayerSpec), _narrow_alexnet(JSpec),
                      shapes, cfg)
    kw = dict(final_sparsity=0.5, start_iter=0, end_iter=4, freq=1,
              granularity="block", block_shape=(4, 4))
    jsol.set_pruning_schedule(jpruning.PruningSchedule(**kw))
    sol.set_pruning_schedule(pruning.PruningSchedule(**kw))
    logs = []
    batches = _batches(shapes, 6, 10, seed=3)
    for i, b in enumerate(batches):
        jsol.step(iter([b]), 1, **QUIET)
        sol.step(iter([b]), 1, log=logs.append)
        if sol.param_masks is not None:
            _close(sol.param_masks, jsol.param_masks, exact=True)
        np.testing.assert_allclose(sol._losses[-1], jsol._losses[-1],
                                   rtol=RTOL)
    _close(sol.params, jsol.params)
    _close(sol.state, jsol.state)
    assert [ln.split(",")[0] for ln in logs] == [
        f"Pruning: iteration {i}" for i in (1, 2, 3, 4)]
    for name in ("conv1", "conv2", "conv3", "fc6", "fc7", "fc8"):
        w = sol.params[name]["w"].numpy()
        m = sol.param_masks[name]["w"].numpy()
        assert (w[m == 0] == 0).all() and 0.3 < (m == 0).mean() < 0.7


def test_snapshots_load_across_packages(tmp_path):
    """The port's .npz restores into the JAX Solver and the JAX one into
    the port's: params, Adam's m and v, BatchNorm sums and the
    iteration."""
    shapes = CIFAR_BN
    cfg = dict(solver_type="adam", base_lr=1e-3)
    jsol, sol = _pair(ZOO["cifar10_bn"][0](include_loss=True),
                      JZOO["cifar10_bn"][0](include_loss=True), shapes, cfg,
                      snapshot_prefix=str(tmp_path / "s"),
                      lr_mults=CIFAR_BN_MULTS)
    batches = _batches(shapes, 2, 10)
    sol.step(iter(batches), 2, **QUIET)
    path = sol.snapshot()
    assert path.endswith("_iter_2")
    jsol.restore(path)
    assert jsol.iter == 2
    _close(jsol.params, sol.params, exact=True)
    _close(jsol.state, sol.state, exact=True)
    _close(jsol.net_state, sol.net_state, exact=True)
    jsol.snapshot_prefix = str(tmp_path / "j")
    jsol.step(iter(batches), 1, **QUIET)
    jpath = jsol.snapshot()
    fresh = Solver(Net(ZOO["cifar10_bn"][0](include_loss=True),
                       phase="train"), solvers.SolverConfig(**cfg),
                   display=0, device="cpu", lr_mults=CIFAR_BN_MULTS)
    fresh.init(shapes)
    fresh.restore(jpath)
    assert fresh.iter == 3
    _close(fresh.params, jsol.params, exact=True)
    _close(fresh.state, jsol.state, exact=True)
    _close(fresh.net_state, jsol.net_state, exact=True)
    # and it trains on from there as the JAX solver does
    fresh.step(iter(batches[:1]), 1, **QUIET)
    jsol.step(iter(batches[:1]), 1, **QUIET)
    _close(fresh.params, jsol.params, atol=ADAM_ATOL)


def _tiny(tmp_path, **kw):
    specs = [LayerSpec("ip", "InnerProduct", ("data",),
                       params=dict(num_output=2)),
             LayerSpec("loss", "SoftmaxWithLoss", ("ip", "label"))]
    s = Solver(Net(specs, phase="train"),
               solvers.SolverConfig(solver_type="sgd", base_lr=0.01),
               snapshot_prefix=str(tmp_path / "t"), display=0, device="cpu",
               **kw)
    s.init({"data": (4, 3), "label": (4,)})
    rng = np.random.default_rng(0)
    batch = {"data": rng.standard_normal((4, 3)).astype(np.float32),
             "label": np.array([0, 1, 0, 1], np.int32)}
    return s, batch


@pytest.fixture
def own_signal_handlers():
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGHUP)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_sighup_snapshots_and_sigint_stops(tmp_path, own_signal_handlers):
    s, batch = _tiny(tmp_path)
    s.install_signal_handlers()
    os.kill(os.getpid(), signal.SIGHUP)
    s.step(iter([batch] * 5), 2, **QUIET)
    assert (tmp_path / "t_iter_1.npz").exists()  # at the first iteration
    assert not (tmp_path / "t_iter_2.npz").exists()
    os.kill(os.getpid(), signal.SIGINT)
    s.step(iter([batch] * 5), 3, **QUIET)
    assert s.iter == 2  # stopped before another iteration


def test_rss_guard_snapshots_and_stops(tmp_path):
    s, batch = _tiny(tmp_path)
    s.rss_limit_gb = 1e-6  # any real process exceeds this at once
    s.rss_check_every = 3
    msgs = []
    s.step(iter([batch] * 100), 100, log=msgs.append)
    assert s.rss_stopped and s.iter == 3
    assert any("RSS" in m and "CESCOIN_RSS_LIMIT_GB" in m for m in msgs)
    s2, _ = _tiny(tmp_path)
    s2.restore(str(tmp_path / "t_iter_3"))
    assert s2.iter == 3
    s2.step(iter([batch] * 10), 10, **QUIET)
    assert s2.iter == 13 and not s2.rss_stopped


@pytest.mark.parametrize("value,want", [("", None), ("2.5", 2.5),
                                        ("lots", ValueError)])
def test_rss_limit_from_the_environment(tmp_path, monkeypatch, value, want):
    monkeypatch.setenv("CESCOIN_RSS_LIMIT_GB", value)
    if want is ValueError:
        with pytest.raises(ValueError, match="CESCOIN_RSS_LIMIT_GB"):
            _tiny(tmp_path)
    else:
        assert _tiny(tmp_path)[0].rss_limit_gb == want


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = Net(ZOO["lenet"][0](include_loss=True), phase="train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver(net, solvers.SolverConfig())
    assert Solver(net, solvers.SolverConfig(), device="cpu").device.type \
        == "cpu"


@pytest.mark.parametrize("solver_type", ["sgd", "nesterov", "adagrad",
                                         "rmsprop", "adadelta", "adam"])
def test_every_solver_reduces_a_least_squares_loss(solver_type):
    """The reference's RunLeastSquaresSolver pattern, on EuclideanLoss."""
    specs = [LayerSpec("ip", "InnerProduct", ("data",),
                       params=dict(num_output=1)),
             LayerSpec("loss", "EuclideanLoss", ("ip", "target"))]
    net = Net(specs, phase="train")
    if solver_type == "adadelta":
        cfg = solvers.SolverConfig(solver_type=solver_type, base_lr=1.0,
                                   momentum=0.9, delta=1e-3)
    else:
        cfg = solvers.SolverConfig(solver_type=solver_type, base_lr=0.05,
                                   momentum=0.5)
    sol = Solver(net, cfg, display=0, device="cpu")
    sol.init({"data": (8, 4), "target": (8, 1)})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    batch = {"data": x,
             "target": x @ rng.standard_normal((4, 1)).astype(np.float32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss0 = float(net.loss(sol.params, tb))
    sol.step(iter([batch] * 60), 50, **QUIET)
    assert float(net.loss(sol.params, tb)) < 0.7 * loss0


def test_param_masks_pin_pruned_weights(tmp_path):
    s, batch = _tiny(tmp_path)
    s.params["ip"]["w"][0] = 0.0
    s.set_param_masks(pruning.masks_of(s.params))
    s.step(iter([batch] * 3), 3, **QUIET)
    assert (s.params["ip"]["w"][0] == 0).all()
    assert (s.params["ip"]["w"][1:] != 0).all()
    assert Net.num_params(s.params) == 3 * 2 + 2


# ---------------------------------------------------------------------------
# utils/pruning.py, the training half


def test_agp_schedule_equals_jax():
    for kw in (dict(start_iter=100, end_iter=1100, final_sparsity=0.9,
                    freq=50),
               dict(start_iter=0, end_iter=12, final_sparsity=0.9, freq=4),
               dict(start_iter=0, end_iter=100, final_sparsity=0.9,
                    initial_sparsity=0.5, freq=1)):
        for t in range(0, 1200, 7):
            assert pruning.agp_sparsity(t, **kw) == \
                jpruning.agp_sparsity(t, **kw)


PARAMS_SHAPES = {"conv1": {"w": (11, 11, 3, 16), "b": (16,)},
                 "conv2": {"w": (3, 3, 8, 16), "b": (16,)},
                 "small": {"w": (1, 1, 3, 8)},
                 "fc": {"w": (64, 32), "b": (32,)},
                 "scale": {"gamma": (8,)}}


@pytest.mark.parametrize("granularity", ["block", "element"])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9])
def test_gradual_masks_equal_jax(granularity, sparsity):
    rng = np.random.default_rng(4)
    params = {n: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in blobs.items()}
              for n, blobs in PARAMS_SHAPES.items()}
    tparams = solvers.tree_map(torch.from_numpy, params)
    got = pruning.gradual_masks(tparams, sparsity, granularity=granularity,
                                block_shape=(4, 4))
    want = jpruning.gradual_masks(params, sparsity, granularity=granularity,
                                  block_shape=(4, 4))
    _close(got, want, exact=True)
    if sparsity:  # the 3-channel 11x11 stem is pruned by the default rule
        assert (got["conv1"]["w"] == 0).any()
        assert (got["small"]["w"] == 1).all()


def test_default_prune_select_keeps_the_jax_stem_rule():
    for shape in ((7, 7, 3, 64), (11, 11, 3, 96), (3, 3, 3, 8),
                  (1, 1, 16, 8), (2, 2, 8, 4), (9216, 4096), (8,)):
        leaf = np.zeros(shape, np.float32)
        for key in ("w", "b"):
            assert pruning.default_prune_select("l", key, leaf) == \
                jpruning.default_prune_select("l", key, leaf)
    assert pruning.default_prune_select("conv1", "w",
                                        np.zeros((7, 7, 3, 64)))


def test_masks_of_sparsity_of_and_densify_blocks_equal_jax():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((20, 12)).astype(np.float32)
    w[rng.random(w.shape) < 0.7] = 0
    params = {"fc": {"w": w, "b": np.zeros(12, np.float32)}}
    _close(pruning.masks_of(solvers.tree_map(torch.from_numpy, params)),
           jpruning.masks_of(params), exact=True)
    assert pruning.sparsity_of(torch.from_numpy(w)) == \
        jpruning.sparsity_of(w)
    for dens in (0.2, 0.4):
        got, gstats = pruning.densify_blocks(w, (4, 4), dens)
        want, wstats = jpruning.densify_blocks(w, (4, 4), dens)
        np.testing.assert_array_equal(got, want)
        assert gstats == wstats


# ---------------------------------------------------------------------------
# data/pipeline.PrefetchLoader


def _counting_source(fail_at=None):
    state = {"i": 0}

    def source():
        state["i"] += 1
        if state["i"] == fail_at:
            raise OSError("record file went away")
        return {"data": np.full((2, 3), state["i"], np.float32),
                "label": np.array([state["i"], 0], np.int32)}
    return source


def test_prefetch_loader_yields_the_jax_loaders_batches():
    with PrefetchLoader(_counting_source(), prefetch=2) as got, \
            jpipeline.PrefetchLoader(_counting_source(), prefetch=2,
                                     device_put=False) as want:
        for _ in range(5):
            a, b = next(got), next(want)
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_loader_to_a_device_and_transform():
    def transform(batch):
        return {**batch, "data": batch["data"] * 2}

    with PrefetchLoader(_counting_source(), transform=transform,
                        device=torch.device("cpu")) as loader:
        batch = next(loader)
    assert isinstance(batch["data"], torch.Tensor)
    assert batch["label"].dtype == torch.int32
    np.testing.assert_array_equal(batch["data"].numpy(),
                                  np.full((2, 3), 2.0))


def test_prefetch_loader_raises_the_sources_error_on_next():
    loader = PrefetchLoader(_counting_source(fail_at=3), prefetch=1)
    try:
        next(loader)
        next(loader)
        with pytest.raises(OSError, match="went away"):
            next(loader)
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_rss_module_reads_proc():
    assert solver_mod._vm_rss_gb() > 0
