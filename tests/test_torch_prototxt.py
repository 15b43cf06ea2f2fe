"""The port's prototxt reader and writer (``tools/prototxt.py``) against the
JAX package's, on text built in the test from the zoo builders.

* ``parse_text`` gives the JAX dict on the JAX test's fixture and on a V0
  net.
* For all ten zoo builders, with and without ``include_loss``, the port's
  ``net_to_prototxt`` text is byte-identical to the JAX text in both compat
  modes, and ``net_from_prototxt`` of it gives the JAX specs field by field.
* A fused ResNet stage (``cescoin_param`` extension fields) emits the JAX
  text, reparses to the fused specs and runs the same function.
* A net whose two fcs share one weight (``param { name }``) runs on one
  weight, as the JAX net.
* lenet read from a prototxt gives the JAX forward (rtol 1e-5).
"""

import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.tools import prototxt as jpt  # noqa: E402

from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.nn import (Net, fuse_inference,  # noqa: E402
                                       params_from_jax)
from caffe_escoin_tpu_torch.tools import prototxt as pt  # noqa: E402

FIXTURE = """
  name: "x"  # comment
  layer { name: "a" type: "ReLU" bottom: "d" top: "a"
          relu_param { negative_slope: 0.1 } }
  input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
  flag: true  enum_f: TRAIN  neg: -4  sci: 1e-5
"""

V0_NET = """
name: "v0net"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 16 input_dim: 16
layers {
  layer { name: "pad1" type: "padding" pad: 2 }
  bottom: "data" top: "pad1"
}
layers {
  layer {
    name: "conv1" type: "conv"
    num_output: 8 kernelsize: 5 stride: 1 group: 1
    blobs_lr: 1.0 blobs_lr: 2.0
    weight_decay: 1.0 weight_decay: 0.0
    weight_filler { type: "gaussian" std: 0.01 }
  }
  bottom: "pad1" top: "conv1"
}
layers {
  layer { name: "relu1" type: "relu" }
  bottom: "conv1" top: "conv1"
}
layers {
  layer { name: "pool1" type: "pool" kernelsize: 2 stride: 2 pool: MAX }
  bottom: "conv1" top: "pool1"
}
layers {
  layer { name: "drop1" type: "dropout" dropout_ratio: 0.3 }
  bottom: "pool1" top: "pool1"
}
layers {
  layer { name: "fc1" type: "innerproduct" num_output: 4 }
  bottom: "pool1" top: "fc1"
}
layers {
  layer { name: "prob" type: "softmax" }
  bottom: "fc1" top: "prob"
}
"""

SHARED_NET = """
name: "tied"
layer { name: "in" type: "Input" top: "a" top: "b"
        input_param { shape { dim: 2 dim: 6 } shape { dim: 2 dim: 6 } } }
layer { name: "ip_a" type: "InnerProduct" bottom: "a" top: "fa"
        param { name: "w" } param { name: "bias" }
        inner_product_param { num_output: 5 } }
layer { name: "ip_b" type: "InnerProduct" bottom: "b" top: "fb"
        param { name: "w" } param { name: "bias" }
        inner_product_param { num_output: 5 } }
layer { name: "sum" type: "Eltwise" bottom: "fa" bottom: "fb" top: "out" }
"""


def _fields(s):
    return (s.name, s.type, s.bottoms, s.tops, s.params, s.phase,
            s.loss_weight, s.share_params)


def _assert_same_specs(got, want):
    assert [_fields(s) for s in got] == [_fields(s) for s in want]


@pytest.mark.parametrize("text", [FIXTURE, V0_NET], ids=["fixture", "v0"])
def test_parse_text_is_the_jax_dict(text):
    assert pt.parse_text(text) == jpt.parse_text(text)


def test_v0_net_reads_as_jax():
    got, got_shapes, got_name = pt.net_from_prototxt(V0_NET)
    want, want_shapes, want_name = jpt.net_from_prototxt(V0_NET)
    assert (got_name, got_shapes) == (want_name, want_shapes)
    _assert_same_specs(got, want)
    assert "pad1" not in {s.name for s in got}
    net = Net(got)
    params = net.init(torch.Generator().manual_seed(0), got_shapes)
    out = net(params, {"data": torch.zeros(got_shapes["data"])})
    assert out["prob"].shape == (1, 4)


# (model, include_loss): every builder, with include_loss where it takes it
# (rcnn_ilsvrc13's raw-score head has no loss variant)
BUILDS = [(m, inc) for m in sorted(JZOO) for inc in (False, True)
          if not inc or "include_loss" in inspect.signature(
              JZOO[m][0]).parameters]


@pytest.mark.parametrize("compat", ["cescoin", "caffe"])
@pytest.mark.parametrize("model,include_loss", BUILDS)
def test_zoo_prototxt_is_the_jax_text(model, include_loss, compat):
    kw = {"include_loss": True} if include_loss else {}
    specs = ZOO[model][0](**kw)
    jspecs = JZOO[model][0](**kw)
    shapes = ZOO[model][1]
    text = pt.net_to_prototxt(specs, shapes, name=model, compat=compat)
    assert text == jpt.net_to_prototxt(jspecs, JZOO[model][1], name=model,
                                       compat=compat)
    got, got_shapes, name = pt.net_from_prototxt(text, phase="train")
    want, want_shapes, _ = jpt.net_from_prototxt(text, phase="train")
    assert (name, got_shapes) == (model, want_shapes)
    _assert_same_specs(got, want)


def _res2(specs):
    """ResNet-50's stem and stage 2 (the specs up to res3)."""
    keep = []
    for s in specs:
        if s.name.startswith(("res3", "bn_res3", "scale_res3")):
            break
        keep.append(s)
    return keep


def test_fused_resnet_stage_round_trips():
    shapes = {"data": (1, 32, 32, 3)}
    jnet = JNet(_res2(JZOO["resnet50"][0]()))
    jparams = jnet.init(jax.random.PRNGKey(0), shapes)
    jfnet, _ = jfuse(jnet, jparams, state=jnet.state0)
    params, state = params_from_jax(jparams, jnet.state0)
    net = Net(_res2(ZOO["resnet50"][0]()))
    net.init(torch.Generator().manual_seed(0), shapes)
    fnet, fparams = fuse_inference(net, params, state=state)
    fspecs = [l.spec for l in fnet.layers]
    assert any(s.params.get("fuse_add") for s in fspecs)
    text = pt.net_to_prototxt(fspecs, shapes, name="res2")
    assert text == jpt.net_to_prototxt([l.spec for l in jfnet.layers],
                                       shapes, name="res2")
    assert "cescoin_param" in text
    got, got_shapes, _ = pt.net_from_prototxt(text)
    _assert_same_specs(got, jpt.net_from_prototxt(text)[0])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shapes["data"]).astype(np.float32))
    want = fnet(fparams, {"data": x})
    out = Net(got)(fparams, {"data": x})
    assert out.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(out[k], want[k], rtol=0, atol=0)
    strict = pt.net_to_prototxt(fspecs, shapes, compat="caffe")
    assert "cescoin_param" not in strict
    assert not any(s.params.get("fuse_relu")
                   for s in pt.net_from_prototxt(strict)[0])


def test_shared_params_run_on_one_weight():
    specs, shapes, _ = pt.net_from_prototxt(SHARED_NET)
    jspecs, jshapes, _ = jpt.net_from_prototxt(SHARED_NET)
    _assert_same_specs(specs, jspecs)
    assert specs[1].share_params == "ip_a"
    jnet = JNet(jspecs)
    jparams = jnet.init(jax.random.PRNGKey(3), jshapes)
    net = Net(specs)
    assert set(net.init(torch.Generator().manual_seed(0), shapes)) == {"ip_a"}
    params, _ = params_from_jax(jparams)
    assert set(params) == {"ip_a"}
    rng = np.random.default_rng(0)
    xs = {k: rng.standard_normal(v).astype(np.float32)
          for k, v in shapes.items()}
    want = np.asarray(jnet.apply(jparams, xs)["out"])
    got = net(params, {k: torch.from_numpy(v) for k, v in xs.items()})["out"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # tied: equal inputs give equal branch outputs
    same = net(params, {"a": torch.from_numpy(xs["a"]),
                        "b": torch.from_numpy(xs["a"])}, return_blobs=True)
    torch.testing.assert_close(same["fa"], same["fb"], rtol=0, atol=0)


def test_lenet_from_prototxt_gives_the_jax_forward():
    text = jpt.net_to_prototxt(JZOO["lenet"][0](), {"data": (2, 28, 28, 1)},
                               name="lenet")
    specs, shapes, _ = pt.net_from_prototxt(text)
    jspecs, jshapes, _ = jpt.net_from_prototxt(text)
    jnet = JNet(jspecs)
    jparams = jnet.init(jax.random.PRNGKey(0), jshapes)
    params, _ = params_from_jax(jparams)
    x = np.random.default_rng(0).standard_normal(shapes["data"]).astype(
        np.float32)
    want = jnet.apply(jparams, {"data": x}, return_blobs=True)
    got = Net(specs)(params, {"data": torch.from_numpy(x)},
                     return_blobs=True)
    for blob in ("ip2", "prob"):
        np.testing.assert_allclose(got[blob].numpy(), np.asarray(want[blob]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", sorted(JZOO))
def test_specs_json_is_the_jax_json(model):
    """``nn/serialize.py``: the same JSON text for the same specs, and
    either package reads the other's."""
    from caffe_escoin_tpu.nn import serialize as jser

    from caffe_escoin_tpu_torch.nn import serialize as ser

    text = ser.specs_to_json(ZOO[model][0](), name=model)
    assert text == jser.specs_to_json(JZOO[model][0](), name=model)
    _assert_same_specs(ser.specs_from_json(text), jser.specs_from_json(text))
