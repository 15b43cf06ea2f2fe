"""Sparse AlexNet on the port's kernel routes, on the CPU, against the
benchmark's plain reference (``portbench/reference/alexnet.py``): the
configuration ``portbench/configs/alexnet-block90.json`` at 2 images of
227x227, its seeded weights pruned by ``portbench.weights``' rule (90% of
128x128 blocks of conv2-5, each group's own (Cin/group, Cout) plane, and
of fc6-8; conv1 dense), through ``Net``: ``fuse_inference``,
``weight_align``, ``inference_fn`` (eager on the CPU, where each kernel
entry runs its plain version).

* In float32 the logits are within ``F32_TOL`` of the reference's, a
  bound that the program in bfloat16 misses.
* In bfloat16 (the configuration's policy) they are within the
  configuration's ``logit_rel_err`` limit.
* ``Net.weight_align``'s set-up counters ``align.grouped.*`` add what the
  grouped convs' BSCs hold: one a conv, the stored nonzero weights, and
  the GEMM view's live blocks x bk x bn; conv2's kept 48x128 blocks fill
  at most half of the view's 96x128 blocks.
* A grouped conv whose pruned blocks line up with the view's (Cin/group =
  bk, Cout/group = bn) fills its blocks whole.
"""

import json
from pathlib import Path

import pytest
import torch

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu_torch.models import ZOO
from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
from caffe_escoin_tpu_torch.nn.net import LayerSpec
from caffe_escoin_tpu_torch.utils import trace
from portbench import check, weights
from portbench.reference import alexnet, plain
from portbench.system import port_params

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench/configs/alexnet-block90.json")
                 .read_text())
SEED = 2 ** 31 + 26
GROUPED = ("conv2", "conv4", "conv5")
COUNTERS = ("align.grouped.convs", "align.grouped.nnz",
            "align.grouped.block_slots")
# float32 on both sides: the program's products and the reference's
# differ only in the order of their f32 sums (the kernels' blocks against
# F.conv2d and one matmul), 2.9e-7 at the logits on three seeds; bfloat16
# rounds every product's operands, 2.7e-3 to 2.9e-3 there. The bound sits
# a factor 30 above the first and more than 200 below the second
F32_TOL = 1e-5


def _policy(dtype):
    return ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                           block_shape=(128, 128), compute_dtype=dtype,
                           cast_back=False, use_xla_sparse=False)


@pytest.fixture(scope="module")
def made():
    """(table, params, pruned names, two images) of the configuration."""
    table, params, pruned = weights.make_net(CFG, alexnet, SEED, "cpu")
    x = weights.images(2, tuple(CFG["input_hwc"]),
                       weights.generator(SEED, weights.POOL, "cpu"), "cpu")
    return table, params, pruned, x


def _counters():
    c = trace.snapshot()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


def _aligned(table, params, dtype):
    """(fused net, aligned params on the CPU in ``dtype``, the counters
    ``weight_align`` added)."""
    net = Net(ZOO["alexnet"][0](num_classes=CFG["num_classes"]),
              policy=_policy(dtype), phase="test")
    pp, state = port_params(net, table, params)
    fnet, fparams = fuse_inference(net, pp, state=state)
    before = _counters()
    aligned = fnet.weight_align(fparams)
    added = {k: v - before[k] for k, v in _counters().items()}
    return fnet, params_to(aligned, "cpu", dtype), added


def _logits(table, params, x, dtype):
    fnet, aligned, _ = _aligned(table, params, dtype)
    return fnet.inference_fn(aligned, cuda_graph=True,
                             return_blobs=True)({"data": x})["fc8"].float()


def test_pruned_as_the_configuration_says(made):
    _, _, pruned, _ = made
    assert pruned == ["conv2", "conv3", "conv4", "conv5", "fc6", "fc7",
                      "fc8"]


def test_routes_and_launches(made):
    """conv2-5 on ``sconv_fused``, fc6-8 on ``bsc_spmm``, conv1 dense (on
    ``stem_conv``, so no epilogue launch), as
    ``Net.launches`` declares them (``tests/test_torch_launches.py`` holds
    the declaration to a forward's calls)."""
    table, params, _, x = made
    fnet, aligned, _ = _aligned(table, params, torch.bfloat16)
    shapes = {"data": tuple(x.shape)}
    routes = fnet.routes(aligned, shapes)
    assert routes["conv1"] == "dense"
    assert {routes[n] for n in ("conv2", "conv3", "conv4", "conv5")} == {
        "fused"}
    assert {routes[n] for n in ("fc6", "fc7", "fc8")} == {"spmm"}
    declared = fnet.launches(aligned, shapes, torch.bfloat16)
    assert (declared["sconv_fused"], declared["bsc_spmm"], declared["lrn"],
            declared["maxpool"], declared["conv_epilogue"],
            declared["stem_conv"]) == (4, 3, 2, 3, 0, 1)


def test_float32_within_the_reference_and_bfloat16_not(made):
    table, params, _, x = made
    ref = plain.forward(table, params, x, outputs=("fc8",))["fc8"]
    err32 = float(check.rel_err(_logits(table, params, x, None), ref).max())
    err16 = float(check.rel_err(_logits(table, params, x, torch.bfloat16),
                                ref).max())
    assert err32 <= F32_TOL, err32
    assert err16 > F32_TOL, err16


def test_bfloat16_within_the_configuration_limit(made):
    table, params, _, x = made
    ref = plain.forward(table, params, x, outputs=("fc8",))["fc8"]
    got = _logits(table, params, x, torch.bfloat16)
    assert torch.isfinite(got).all()
    err = float(check.rel_err(got, ref).max())
    assert err <= CFG["limits"]["logit_rel_err"], err


def test_grouped_counters_are_what_the_bscs_hold(made):
    table, params, _, _ = made
    _, aligned, added = _aligned(table, params, torch.bfloat16)
    grouped = {n: aligned[n] for n in GROUPED}
    assert all(a.groups == 2 and a.bsc is not None
               for a in grouped.values())
    assert not [n for n, a in aligned.items() if n not in GROUPED
                and getattr(a, "groups", 1) > 1]
    nnz = {n: int((a.dense != 0).sum()) for n, a in grouped.items()}
    slots = {n: a.bsc.nnz_blocks * a.bsc.block_shape[0]
             * a.bsc.block_shape[1] for n, a in grouped.items()}
    assert added == {"align.grouped.convs": 3,
                     "align.grouped.nnz": sum(nnz.values()),
                     "align.grouped.block_slots": sum(slots.values())}
    # the blocks live in the view hold exactly the stored weights
    for n, a in grouped.items():
        assert int((a.bsc.blocks != 0).sum()) == nnz[n], n
    # conv2: Cin 96 is one K-block, so a kept 48x128 block of one group
    # sits in a 96x128 block of the view beside 48 zero rows
    assert grouped["conv2"].bsc.block_shape == (96, 128)
    assert 0 < nnz["conv2"] / slots["conv2"] <= 0.5
    assert sum(nnz.values()) < sum(slots.values())


def test_blocks_that_follow_the_groups_fill_whole():
    """Cin/group = bk = 128 and Cout/group = bn = 128: each block pruned
    in a group's plane is one block of the view."""
    cin = cout = 256
    spec = LayerSpec("conv", "ConvolutionReLU", ("data",), params=dict(
        num_output=cout, kernel=3, pad=1, group=2))
    net = Net([spec], policy=_policy(torch.bfloat16), phase="test")
    g = torch.Generator().manual_seed(3)
    w = torch.randn((3, 3, cin // 2, cout), generator=g)
    e = plain.conv("conv", "data", cout, 3, pad=1, group=2)
    w = weights.prune_layer(e, w, 0.9, (128, 128), 32)
    before = _counters()
    (a,) = net.weight_align({"conv": {"w": w, "b": torch.zeros(cout)}}
                            ).values()
    added = {k: v - before[k] for k, v in _counters().items()}
    assert a.bsc.block_shape == (128, 128) and a.bsc.nnz_blocks >= 1
    assert added["align.grouped.convs"] == 1
    assert added["align.grouped.nnz"] == int((w != 0).sum())
    assert added["align.grouped.nnz"] == added["align.grouped.block_slots"]


def test_no_counter_for_a_dense_grouped_or_an_ungrouped_conv():
    """A grouped conv left dense has no BSC; an ungrouped sparse conv has
    no block-diagonal view."""
    specs = [LayerSpec("grouped", "ConvolutionReLU", ("data",), params=dict(
                 num_output=64, kernel=3, pad=1, group=2)),
             LayerSpec("plain", "ConvolutionReLU", ("grouped",), params=dict(
                 num_output=128, kernel=3, pad=1))]
    net = Net(specs, policy=_policy(torch.bfloat16), phase="test")
    w = torch.zeros((3, 3, 64, 128))
    w[1, 1, :, :] = 1.0
    before = _counters()
    aligned = net.weight_align({"grouped": {"w": torch.ones((3, 3, 32, 64))},
                                "plain": {"w": w}})
    assert aligned["grouped"].bsc is None
    assert aligned["plain"].bsc is not None
    assert _counters() == before
