"""The port's ``.caffemodel`` reader and writer (``tools/caffemodel.py``)
against the JAX package's, on files written in the test.

* Given the same params (and BatchNorm state), ``save_caffemodel`` writes
  the same bytes in both packages: lenet, and cifar10_bn with its state.
* The port's import of a JAX-written file equals ``params_from_jax`` of the
  JAX params exactly, and ``batchnorm_state`` the JAX state.
* A Flatten between a conv and an fc: the fc rows are reordered through it
  (Caffe's (c, h, w) flatten against NHWC's (h, w, c)) exactly as the JAX
  import does, and the imported net gives the JAX forward.
* An import rule that does not match the layer's params raises, in both
  packages: params without the key the rule writes, and a shape.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.tools import caffemodel as jcm  # noqa: E402

from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.nn import LayerSpec, Net  # noqa: E402
from caffe_escoin_tpu_torch.nn import params_from_jax  # noqa: E402
from caffe_escoin_tpu_torch.tools import caffemodel as cm  # noqa: E402


def _quiet(*_):
    pass


def _nets(model, batch=2, seed=0):
    """(JAX net, its params and a random BatchNorm state, the port's net,
    the same params and state as tensors)."""
    shapes = {"data": (batch,) + JZOO[model][1]["data"][1:]}
    jnet = JNet(JZOO[model][0]())
    jparams = jnet.init(jax.random.PRNGKey(seed), shapes)
    rng = np.random.default_rng(seed)
    jstate = {k: {"mean_acc": rng.standard_normal(v["mean_acc"].shape
                                                  ).astype(np.float32),
                  "var_acc": rng.uniform(0.5, 2.0, v["var_acc"].shape
                                         ).astype(np.float32),
                  "count": np.float32(rng.uniform(1.0, 3.0))}
              for k, v in jnet.state0.items()}
    net = Net(ZOO[model][0]())
    net.init(torch.Generator().manual_seed(seed), shapes)
    params, state = params_from_jax(jparams, jstate)
    return jnet, jparams, jstate, net, params, state


def _assert_params_equal(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for k in want[name]:
            assert got[name][k].dtype == torch.float32
            assert torch.equal(got[name][k], want[name][k]), (name, k)


@pytest.mark.parametrize("model", ["lenet", "cifar10_bn"])
def test_save_writes_the_jax_bytes(model, tmp_path):
    jnet, jparams, jstate, net, params, state = _nets(model)
    jcm.save_caffemodel(jnet, jparams, str(tmp_path / "j.caffemodel"),
                        state=jstate, net_name=model, log=_quiet)
    cm.save_caffemodel(net, params, str(tmp_path / "t.caffemodel"),
                       state=state, net_name=model, log=_quiet)
    assert (tmp_path / "t.caffemodel").read_bytes() == \
        (tmp_path / "j.caffemodel").read_bytes()


@pytest.mark.parametrize("model", ["lenet", "cifar10_bn"])
def test_import_of_a_jax_file_is_exact(model, tmp_path):
    jnet, jparams, jstate, _, _, _ = _nets(model)
    path = str(tmp_path / "j.caffemodel")
    jcm.save_caffemodel(jnet, jparams, path, state=jstate, log=_quiet)
    # another seed: every imported value must come from the file
    _, _, _, net, fresh, _ = _nets(model, seed=1)
    loaded = cm.load_caffemodel(path)
    got = cm.assign_to_params(net, fresh, loaded, log=_quiet)
    want, want_state = params_from_jax(jparams, jstate)
    _assert_params_equal(got, want)
    bn = cm.batchnorm_state(loaded)
    assert bn.keys() == want_state.keys()
    for name in want_state:
        for k in ("mean_acc", "var_acc", "count"):
            assert torch.equal(bn[name][k], want_state[name][k]), (name, k)


FLAT = [
    ("conv1", "Convolution", ("data",), dict(num_output=4, kernel=3)),
    ("flat", "Flatten", ("conv1",), {}),
    ("fc", "InnerProduct", ("flat",), dict(num_output=5)),
]


def test_flatten_before_fc_keeps_the_row_reorder(tmp_path):
    shapes = {"data": (2, 6, 5, 3)}  # a 4x3x4 map: (c,h,w) != (h,w,c)
    jnet = JNet([JSpec(n, t, b, params=p) for n, t, b, p in FLAT])
    jparams = jnet.init(jax.random.PRNGKey(0), shapes)
    path = str(tmp_path / "flat.caffemodel")
    jcm.save_caffemodel(jnet, jparams, path, log=_quiet)
    jother = jnet.init(jax.random.PRNGKey(1), shapes)
    want = jcm.assign_to_params(jnet, jother, jcm.load_caffemodel(path),
                                log=_quiet)
    net = Net([LayerSpec(n, t, b, params=p) for n, t, b, p in FLAT])
    fresh = net.init(torch.Generator().manual_seed(1), shapes)
    got = cm.assign_to_params(net, fresh, cm.load_caffemodel(path),
                              log=_quiet)
    _assert_params_equal(got, params_from_jax(want)[0])
    # the file holds Caffe's row order, not the NHWC one
    raw = cm.load_caffemodel(path)["fc"]["blobs"][0]
    assert not np.array_equal(raw.T, np.asarray(jparams["fc"]["w"]))
    x = np.random.default_rng(0).standard_normal(shapes["data"]).astype(
        np.float32)
    np.testing.assert_allclose(
        net(got, {"data": torch.from_numpy(x)})["fc"].numpy(),
        np.asarray(jnet.apply(jparams, {"data": x})["fc"]),
        rtol=1e-5, atol=1e-6)


def test_import_rule_mismatch_raises(tmp_path):
    jnet, jparams, _, net, params, _ = _nets("lenet")
    path = str(tmp_path / "lenet.caffemodel")
    cm.save_caffemodel(net, params, path, log=_quiet)
    loaded = cm.load_caffemodel(path)
    # params whose keys are not the ones the fc's rule writes
    wrong = dict(params, ip1={"gamma": torch.ones(500)})
    with pytest.raises(ValueError, match="import-rule mismatch"):
        cm.assign_to_params(net, wrong, loaded, log=_quiet)
    with pytest.raises(ValueError, match="import-rule mismatch"):
        jcm.assign_to_params(jnet, dict(jparams, ip1={"gamma": np.ones(500)}),
                             jcm.load_caffemodel(path), log=_quiet)
    # a classifier of another width
    narrow = Net(ZOO["lenet"][0](num_classes=5))
    p5 = narrow.init(torch.Generator().manual_seed(0), {"data": (2, 28, 28, 1)})
    with pytest.raises(ValueError, match="does not match"):
        cm.assign_to_params(narrow, p5, loaded, log=_quiet)
