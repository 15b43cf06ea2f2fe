"""The port's solver functions (``engine/solvers.py``,
``engine/lr_policies.py``, the solver half of ``tools/prototxt.py``)
against the JAX package's, on the same numpy inputs made from a seed.

Tolerances: three f32 update steps agree to rtol 1e-5, atol 1e-7 (the
same formulas, rounded in another order where torch fuses a multiply-add;
the adaptive solvers' sqrt and division amplify the last bit). Adam's
bias correction sqrt(1-b2^t)/(1-b1^t) is computed in f32 by the JAX
package, where 1 - 0.999^t keeps about 19 bits, and in f64 by the port:
its three steps of up to 0.4 agree to atol 5e-6. Regularization and
clipping to rtol 1e-6. The LR policies are pure Python and must be equal;
the prototxt text byte-identical.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine import lr_policies as jlr  # noqa: E402
from caffe_escoin_tpu.engine import solvers as jsolvers  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.tools import prototxt as jproto  # noqa: E402

from caffe_escoin_tpu_torch.engine import lr_policies, solvers  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net  # noqa: E402
from caffe_escoin_tpu_torch.tools import prototxt  # noqa: E402

ALL_SOLVERS = ["sgd", "nesterov", "adagrad", "rmsprop", "adadelta", "adam"]


def _tree(rng, shapes, scale=1.0):
    return {layer: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                    for k, s in blobs.items()}
            for layer, blobs in shapes.items()}


SHAPES = {"conv": {"w": (3, 3, 8, 8), "b": (8,)},
          "fc": {"w": (16, 12), "b": (12,)},
          "frozen": {"w": (4, 4)}}


def _t(tree):
    return solvers.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach() if hasattr(tree, "detach") else tree)


def _close(got, want, **tol):
    want = _np(want)
    got = _np(got)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], **tol)
        else:
            np.testing.assert_allclose(got[k], want[k], **tol)


@pytest.mark.parametrize("solver_type", ALL_SOLVERS)
def test_three_updates_match_jax(solver_type):
    """Three steps with per-blob lr and decay multipliers (lr_mult 0
    freezes a blob, 2 doubles a bias's step; decay_mult 0 spares a bias),
    the rate changing between steps (where torch.optim's SGD would
    diverge from Caffe's)."""
    rng = np.random.default_rng(0)
    cfg = jsolvers.SolverConfig(solver_type=solver_type, momentum=0.9,
                                weight_decay=5e-3, delta=1e-6)
    tcfg = solvers.SolverConfig(**cfg.__dict__)
    params = _tree(rng, SHAPES)
    lr_mults = {"conv": {"w": 1.0, "b": 2.0}, "fc": {"w": 0.5, "b": 2.0},
                "frozen": {"w": 0.0}}
    decay_mults = {"conv": {"w": 1.0, "b": 0.0}, "fc": {"w": 2.0, "b": 0.0},
                   "frozen": {"w": 1.0}}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jsolvers.init_state(cfg, jp)
    tp = _t(params)
    ts = solvers.init_state(tcfg, tp)
    assert sorted(ts) == sorted(js)
    for it, lr in enumerate((0.1, 0.05, 0.2), start=1):
        grads = _tree(rng, SHAPES, 0.5)
        jg = jsolvers.regularize(cfg, jp, jax.tree_util.tree_map(
            jnp.asarray, grads), decay_mults=decay_mults)
        jp, js = jsolvers.update(cfg, jp, jg, js, jnp.float32(lr),
                                 jnp.int32(it), lr_mults=lr_mults)
        tg = solvers.regularize(tcfg, tp, _t(grads), decay_mults=decay_mults)
        out_p, out_s = solvers.update(tcfg, tp, tg, ts, lr, it,
                                      lr_mults=lr_mults)
        assert out_p is tp and out_s is ts  # in place
        atol = 5e-6 if solver_type == "adam" else 1e-7
        _close(tp, jp, rtol=1e-5, atol=atol)
        _close(ts, js, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tp["frozen"]["w"].numpy(),
                                  params["frozen"]["w"])


def test_sgd_step_is_caffes_not_torch_optims():
    """Caffe's v = m*v + lr*g; w -= v, analytically, with the rate changed
    on the second step."""
    cfg = solvers.SolverConfig(solver_type="sgd", momentum=0.9)
    p = {"l": {"w": torch.tensor([1.0, -2.0, 3.0])}}
    g = {"l": {"w": torch.tensor([0.5, 0.5, -1.0])}}
    st = solvers.init_state(cfg, p)
    solvers.update(cfg, p, g, st, 0.1)
    solvers.update(cfg, p, g, st, 0.01)
    gn = np.array([0.5, 0.5, -1.0])
    v1 = 0.1 * gn
    v2 = 0.9 * v1 + 0.01 * gn
    np.testing.assert_allclose(p["l"]["w"].numpy(),
                               np.array([1.0, -2.0, 3.0]) - v1 - v2,
                               rtol=1e-6)


def test_adam_bias_correction_analytic():
    cfg = solvers.SolverConfig(solver_type="adam", delta=1e-8)
    p = {"l": {"w": torch.tensor([1.0, -2.0, 3.0])}}
    g = np.array([0.5, 0.5, -1.0])
    st = solvers.init_state(cfg, p)
    solvers.update(cfg, p, {"l": {"w": torch.tensor(g, dtype=torch.float32)}},
                   st, 0.1, it=1)
    m, v = 0.1 * g, 0.001 * g * g
    corr = math.sqrt(1 - 0.999) / (1 - 0.9)
    np.testing.assert_allclose(
        p["l"]["w"].numpy(),
        np.array([1.0, -2.0, 3.0]) - 0.1 * corr * m / (np.sqrt(v) + 1e-8),
        rtol=1e-5)


@pytest.mark.parametrize("kind", ["L1", "L2", "group_lasso"])
def test_regularize_matches_jax(kind):
    """L1, L2 and group lasso (4x4 blocks of a conv's per-offset planes and
    of an fc weight), with a per-layer override and decay multipliers."""
    rng = np.random.default_rng(1)
    cfg = jsolvers.SolverConfig(weight_decay=0.1, regularization_type=kind,
                                group_block=(4, 4))
    tcfg = solvers.SolverConfig(**cfg.__dict__)
    shapes = {"conv": {"w": (3, 3, 6, 10), "b": (10,)},
              "fc": {"w": (9, 7), "b": (7,)}}
    params, grads = _tree(rng, shapes), _tree(rng, shapes)
    params["fc"]["w"][:4, :4] = 0  # an all-zero block
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
    dm = {"conv": {"w": 1.0, "b": 0.0}, "fc": {"w": 0.5, "b": 1.0}}
    for over, mults in ((None, None), ({"fc": "L1"}, dm)):
        want = jsolvers.regularize(cfg, jparams, jgrads, over,
                                   decay_mults=mults)
        got = solvers.regularize(tcfg, _t(params), _t(grads), over,
                                 decay_mults=mults)
        _close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(3, 3, 6, 10), (9, 7), (5,)])
def test_group_lasso_grad_matches_jax(shape):
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(
        solvers.group_lasso_grad(torch.from_numpy(w), (4, 4)).numpy(),
        np.asarray(jsolvers.group_lasso_grad(jnp.asarray(w), (4, 4))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [-1.0, 1.0, 100.0])
def test_clip_gradients_matches_jax(clip):
    rng = np.random.default_rng(3)
    grads = _tree(rng, SHAPES)
    cfg = jsolvers.SolverConfig(clip_gradients=clip)
    want = jsolvers.clip_gradients(cfg, jax.tree_util.tree_map(jnp.asarray,
                                                               grads))
    got = solvers.clip_gradients(solvers.SolverConfig(clip_gradients=clip),
                                 _t(grads))
    _close(got, want, rtol=1e-6, atol=1e-7)


POLICIES = [
    dict(policy="fixed"),
    dict(policy="step", gamma=0.1, step_size=5),
    dict(policy="exp", gamma=0.5),
    dict(policy="inv", gamma=1e-4, power=0.75),
    dict(policy="multistep", gamma=0.1, stepvalues=(2, 5, 9)),
    dict(policy="poly", power=2.0, max_iter=20),
    dict(policy="sigmoid", gamma=-0.5, step_size=6),
]


@pytest.mark.parametrize("kw", POLICIES, ids=[k["policy"] for k in POLICIES])
def test_lr_policies_equal_jax(kw):
    for it in range(0, 20):
        assert lr_policies.learning_rate(it, base_lr=0.3, **kw) == \
            jlr.learning_rate(it, base_lr=0.3, **kw)
    with pytest.raises(ValueError):
        lr_policies.learning_rate(0, base_lr=1.0, policy="cosine")


LENET_MULTS = """
name: "LeNet"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 2 dim: 1 dim: 28 dim: 28 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  param { lr_mult: 1 } param { lr_mult: 2 }
  convolution_param { num_output: 4 kernel_size: 5 stride: 1 } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
  param { lr_mult: 0 decay_mult: 0 } param { lr_mult: 2 decay_mult: 0 }
  inner_product_param { num_output: 10 } }
layer { name: "scale" type: "Scale" bottom: "ip1" top: "sc"
  param { lr_mult: 3 } scale_param { bias_term: true } }
layer { name: "prelu" type: "PReLU" bottom: "sc" top: "pr"
  param { decay_mult: 0.5 } }
"""


def test_param_multipliers_from_a_prototxt_lenet():
    """lr_mult/decay_mult of a prototxt-loaded net: Caffe's blob order
    (weights, bias; Scale's gamma, beta; PReLU's alpha)."""
    from caffe_escoin_tpu.tools.prototxt import net_from_prototxt as jload

    specs, shapes, _ = prototxt.net_from_prototxt(LENET_MULTS)
    jspecs, jshapes, _ = jload(LENET_MULTS)
    net, jnet = Net(specs), JNet(jspecs)
    params = net.init(torch.Generator().manual_seed(0), shapes)
    jparams = jnet.init(jax.random.PRNGKey(0), jshapes)
    got = solvers.param_multipliers(net, params)
    want = jsolvers.param_multipliers(jnet, jparams)
    assert got == want
    assert got[0]["ip1"] == {"w": 0.0, "b": 2.0}
    assert got[0]["scale"] == {"gamma": 3.0, "beta": 1.0}
    assert got[1]["prelu"] == {"alpha": 0.5}
    net2 = Net(prototxt.net_from_prototxt(LENET_MULTS.split(
        'layer { name: "scale"')[0])[0])
    plain = {k: v for k, v in params.items() if k in ("conv1", "ip1")}
    assert solvers.param_multipliers(net2, plain)[0]["conv1"]["b"] == 2.0


SOLVER_CFGS = [
    dict(solver_type="sgd", base_lr=0.01, momentum=0.9, weight_decay=5e-4,
         lr_policy="step", gamma=0.1, step_size=1000),
    dict(solver_type="adam", base_lr=1e-3, adam_beta2=0.99, delta=1e-7,
         clip_gradients=10.0, iter_size=2, lr_policy="multistep",
         stepvalues=(100, 200)),
    dict(solver_type="rmsprop", rms_decay=0.98, regularization_type="L1",
         lr_policy="inv", gamma=1e-4, power=0.75),
]
RUNS = [
    {"net": "lenet_train.prototxt", "display": 10, "snapshot": 500,
     "snapshot_prefix": "snap/lenet", "test_iter": 5, "test_interval": 100},
    {},
    {"train_net": "a.prototxt", "test_net": "b.prototxt", "random_seed": 7},
]


@pytest.mark.parametrize("i", range(len(SOLVER_CFGS)))
def test_solver_prototxt_round_trip_is_the_jax_text(i):
    jcfg = jsolvers.SolverConfig(**SOLVER_CFGS[i])
    cfg = solvers.SolverConfig(**SOLVER_CFGS[i])
    text = prototxt.solver_to_prototxt(cfg, RUNS[i])
    assert text == jproto.solver_to_prototxt(jcfg, RUNS[i])
    got_cfg, got_run = prototxt.solver_from_prototxt(text)
    want_cfg, want_run = jproto.solver_from_prototxt(text)
    assert got_cfg.__dict__ == want_cfg.__dict__
    assert got_run == want_run
    assert got_cfg == cfg
    # the reference's enum spelling and solver_type field
    legacy = "solver_type: NESTEROV\nbase_lr: 0.5\nstepvalue: 3\n"
    assert prototxt.solver_from_prototxt(legacy)[0].__dict__ == \
        jproto.solver_from_prototxt(legacy)[0].__dict__
