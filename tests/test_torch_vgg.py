"""Port parity for the VGG-16 slice: a narrow VGG-16 (the same builder on
both sides with its channel table narrowed, 32x32 input) is initialised by
the JAX package, carried over with ``params_from_jax``, pruned, fused and
weight-aligned on both sides, and run blob by blob: the port's plain routes
against JAX ``Net.apply`` with its Pallas kernels in interpret mode. rtol
1e-4, atol 1e-5 (f32 on both sides, sums in another order).

Both sides' size budgets are narrowed with the shapes, so that the three
SCONV routes all run: stages 1-2 lowered (im2col + SpMM), stage 3 the
garbage-column kernel, stages 4-5 the fused kernel.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_fused as jsconv_fused  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_pallas as jsconv_pallas  # noqa: E402
from caffe_escoin_tpu.models import vgg as jvgg  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.ops import activations as jact  # noqa: E402
from caffe_escoin_tpu.ops import conv as jconv  # noqa: E402
from caffe_escoin_tpu.utils import pruning as jpruning  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import (bsc_spmm, sconv_fused,  # noqa: E402
                                            sconv_gc)
from caffe_escoin_tpu_torch.models import ZOO, vgg  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_from_jax  # noqa: E402
from caffe_escoin_tpu_torch.ops import activations as act  # noqa: E402
from caffe_escoin_tpu_torch.utils import pruning  # noqa: E402

BLOCK = (16, 16)
SPARSITY = 0.75
SHAPES = {"data": (2, 32, 32, 3)}
NARROW = [(1, [8, 8]), (2, [16, 16]), (3, [16, 16, 16]), (4, [32, 32, 32]),
          (5, [32, 32, 32])]
# At these shapes the fused gate's VMEM total is 83-208 KiB in stages 1-3
# and 25-47 KiB in stages 4-5; the garbage-column slab is 7 KiB in stage 3
# and 11-37 KiB before it.
VMEM_BUDGET = 64 * 1024
SLAB_BUDGET = 8 * 1024
TOL = dict(rtol=1e-4, atol=1e-5)
EXPECT_ROUTES = {
    "conv1_1": "dense", "conv1_2": "lowered", "conv2_1": "lowered",
    "conv2_2": "lowered", "conv3_1": "gc", "conv3_2": "gc", "conv3_3": "gc",
    "conv4_1": "fused", "conv4_2": "fused", "conv4_3": "fused",
    "conv5_1": "fused", "conv5_2": "fused", "conv5_3": "fused",
    "fc6": "spmm", "fc7": "spmm", "fc8": "spmm"}


def _prune(specs, params, prune_conv, prune_blocks, asarray):
    """Prune conv weights (not the 3-channel stem) and fc weights, then
    scale each pruned weight back to its norm, so that the signal does not
    fade through sixteen pruned layers."""
    out = dict(params)
    for s in specs:
        if s.name not in out or s.type not in ("ConvolutionReLU",
                                               "InnerProduct"):
            continue
        q = dict(out[s.name])
        w = np.asarray(q["w"])
        if s.type == "InnerProduct":
            wp = prune_blocks(w, SPARSITY, BLOCK)
        elif w.shape[2] >= 8:
            wp = prune_conv(w, SPARSITY, BLOCK)
        else:
            continue
        q["w"] = asarray(wp * np.float32(np.linalg.norm(w)
                                         / np.linalg.norm(wp)))
        out[s.name] = q
    return out


@pytest.fixture(scope="module")
def slice_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvgg, "_CFG", NARROW)
        mp.setattr(vgg, "_CFG", NARROW)
        jpol = JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=BLOCK,
                       use_pallas=True, interpret=True, mxu_dtype="float32",
                       use_xla_sparse=False, spmm_tile_m=64)
        jnet = JNet(jvgg.vgg16(num_classes=10), policy=jpol, phase="test")
        jparams = jnet.init(jax.random.PRNGKey(0), SHAPES)
        np_params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                     for k, v in jparams.items()}
        pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                              use_xla_sparse=False)
        net = Net(vgg.vgg16(num_classes=10), policy=pol)
        params, _ = params_from_jax(np_params)

        jpruned = _prune(jnet.specs, np_params, jpruning.prune_conv_weight,
                         jpruning.prune_blocks, jnp.asarray)
        pruned = _prune(net.specs, params, pruning.prune_conv_weight,
                        pruning.prune_blocks, torch.from_numpy)
        jfnet, jfparams = jfuse(jnet, jpruned)
        fnet, fparams = fuse_inference(net, pruned)
        jaligned = jfnet.weight_align(jfparams)
        aligned = fnet.weight_align(fparams)

        mp.setattr(jsconv_fused, "VMEM_BUDGET", VMEM_BUDGET)
        mp.setattr(sconv_fused, "VMEM_BUDGET", VMEM_BUDGET)
        mp.setattr(jsconv_pallas, "SLAB_BUDGET", SLAB_BUDGET)
        mp.setattr(sconv_gc, "SLAB_BUDGET", SLAB_BUDGET)
        jcalls = {"fused": 0, "gc": 0, "lowered": 0}

        def spy(name, fn):
            def wrapped(*a, **kw):
                jcalls[name] += 1
                return fn(*a, **kw)
            return wrapped

        for mod, attr, name in ((jsconv_fused, "sconv", "fused"),
                                (jsconv_pallas, "sconv", "gc"),
                                (jconv, "conv2d_lowered_sparse", "lowered")):
            mp.setattr(mod, attr, spy(name, getattr(mod, attr)))

        x = np.random.default_rng(1).standard_normal(SHAPES["data"]).astype(
            np.float32)
        jblobs = jfnet.apply(jaligned, {"data": jnp.asarray(x)},
                             return_blobs=True)
        for mod in (sconv_fused, sconv_gc, bsc_spmm):
            mod.reset_counts()
        blobs = fnet.apply(aligned, {"data": torch.from_numpy(x)},
                           return_blobs=True)
        counts = {"fused": sconv_fused.calls, "gc": sconv_gc.calls,
                  "spmm": bsc_spmm.calls,
                  "launches": sconv_fused.launches + sconv_gc.launches
                  + bsc_spmm.launches}
        routes = fnet.routes(aligned, SHAPES)
    return dict(jnet=jnet, net=net, jfnet=jfnet, fnet=fnet, jblobs=jblobs,
                blobs=blobs, counts=counts, jcalls=jcalls, routes=routes)


def test_routes_and_kernel_entries_match_jax(slice_run):
    assert slice_run["routes"] == EXPECT_ROUTES
    jcalls, counts = slice_run["jcalls"], slice_run["counts"]
    assert jcalls == {"fused": 6, "gc": 3, "lowered": 3}
    # the SpMM entry takes the three lowered convs and fc6/fc7/fc8
    assert counts == {"fused": jcalls["fused"], "gc": jcalls["gc"],
                      "spmm": jcalls["lowered"] + 3, "launches": 0}


def test_every_blob_matches_jax_apply(slice_run):
    blobs, jblobs = slice_run["blobs"], slice_run["jblobs"]
    assert set(blobs) == set(jblobs)
    for name, out in blobs.items():
        ref = np.asarray(jblobs[name])
        assert out.shape == ref.shape, name
        assert np.isfinite(out.numpy()).all(), name
        np.testing.assert_allclose(out.numpy(), ref, err_msg=name, **TOL)
    assert blobs["prob"].shape == (2, 10)
    assert float(blobs["fc8"].abs().max()) > 1e-2  # the signal survived


def test_fusion_folds_fc_relu_and_keeps_dropout(slice_run):
    def layout(n):
        return [(s.name, s.type, s.bottoms, s.tops, dict(s.params))
                for s in n.specs]

    fnet = slice_run["fnet"]
    assert layout(fnet) == layout(slice_run["jfnet"])
    assert layout(slice_run["net"]) == layout(slice_run["jnet"])
    by_name = {s.name: s for s in fnet.specs}
    assert "relu6" not in by_name and "relu7" not in by_name
    for fc, top in (("fc6", "fc6r"), ("fc7", "fc7r")):
        assert by_name[fc].params["fuse_relu"] and by_name[fc].tops == (top,)
    assert by_name["drop6"].bottoms == ("fc6r",)
    assert by_name["drop7"].bottoms == ("fc7r",)


def test_full_vgg16_specs_match_jax():
    spec, shapes = ZOO["vgg16"]
    jspecs = jvgg.vgg16()
    assert [(s.name, s.type, s.bottoms, s.tops, s.params) for s in spec()] \
        == [(s.name, s.type, s.bottoms, s.tops, s.params) for s in jspecs]
    assert shapes == jvgg.INPUT_SHAPES


@pytest.mark.parametrize("ratio", [0.5, 0.0])
def test_dropout_is_identity_at_inference(ratio):
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    out = act.dropout(torch.from_numpy(x), ratio)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jact.dropout(jnp.asarray(x), ratio)))
    if ratio:
        with pytest.raises(NotImplementedError, match="training port"):
            act.dropout(torch.from_numpy(x), ratio, train=True)
