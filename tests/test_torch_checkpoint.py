"""The port's ``.npz`` checkpoints (``engine/checkpoint.py``) against the
JAX package's: a checkpoint written by either package loads in the other,
params and BatchNorm state equal and the metadata sidecar kept (cifar10_bn,
which has both)."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.engine import checkpoint as jck  # noqa: E402
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402

from caffe_escoin_tpu_torch.engine import checkpoint as ck  # noqa: E402
from caffe_escoin_tpu_torch.nn import params_from_jax  # noqa: E402


def _jax_params_and_state():
    jnet = JNet(JZOO["cifar10_bn"][0]())
    jparams = jnet.init(jax.random.PRNGKey(0), {"data": (2, 32, 32, 3)})
    rng = np.random.default_rng(0)
    jstate = {k: {kk: (rng.standard_normal(np.shape(vv)).astype(np.float32)
                       if np.ndim(vv) else np.float32(2.5))
                  for kk, vv in v.items()}
              for k, v in jnet.state0.items()}
    return jparams, jstate


def _assert_tree_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.shape == b.shape and a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jparams, jstate = _jax_params_and_state()
    path = str(tmp_path / "snap")
    jck.save_checkpoint(path, jparams, net_state=jstate, meta={"iter": 7})
    params, solver_state, net_state, meta = ck.load_checkpoint_full(path)
    want, want_state = params_from_jax(jparams, jstate)
    assert solver_state is None and meta == {"iter": 7}
    assert all(isinstance(v, torch.Tensor)
               for p in params.values() for v in p.values())
    _assert_tree_equal(params, want)
    _assert_tree_equal(net_state, want_state)
    assert ck.load_checkpoint(path)[2] == {"iter": 7}


def test_port_checkpoint_loads_in_jax(tmp_path):
    jparams, jstate = _jax_params_and_state()
    params, state = params_from_jax(jparams, jstate)
    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    ck.save_checkpoint(tpath, params, net_state=state, meta={"iter": 3})
    jck.save_checkpoint(jpath, jparams, net_state=jstate, meta={"iter": 3})
    with np.load(tpath + ".npz") as t, np.load(jpath + ".npz") as j:
        assert sorted(t.files) == sorted(j.files)
    got_params, _, got_state, meta = jck.load_checkpoint_full(tpath)
    assert meta == json.loads((tmp_path / "j.json").read_text())
    _assert_tree_equal(got_params, jparams)
    _assert_tree_equal(got_state, jstate)
