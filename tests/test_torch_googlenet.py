"""Port parity for the GoogLeNet and AlexNet slice, whole nets at a small
size: a narrow GoogLeNet built in the test from both packages' own
``_conv``/``_inception`` helpers (the stem, both LRNs, two inception blocks
with narrow channel tables, the pools, the classifier and softmax) at
2x64x64, and a narrow AlexNet-pattern net (11x11/4 stem, LRN, grouped 5x5
and 3x3 convs, the fc) at 2x67x67. The JAX package initialises them; both
sides prune the same weights (75% in 8x8 blocks, every pruned weight
scaled back to its norm, inputs of fewer than 8 channels per group kept
dense), fuse and weight-align them, and run:

* dense f32 (cuDNN's counterpart on the CPU);
* aligned on the kernel routes (``use_xla_sparse=False``): the port's plain
  versions against the JAX Pallas kernels in interpret mode;
* aligned on the XBSP branch (the default executor, no autotune).

Every blob within rtol 1e-4, atol 1e-5 (f32 on both sides, sums in another
order). Then the stem transforms bench.py applies to GoogLeNet: fused, fused
+ s2d and fused + s2d + pack give the same logits in the port (rtol 1e-4,
atol 1e-5) and the JAX package's on the same transforms.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_fused as jsconv_fused  # noqa: E402
from caffe_escoin_tpu.models import googlenet as jgooglenet  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JLayerSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fold_stem_s2d as jfold  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.nn.fuse import pack_narrow_chains as jpack  # noqa: E402
from caffe_escoin_tpu.utils import pruning as jpruning  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_fused  # noqa: E402
from caffe_escoin_tpu_torch.models import googlenet  # noqa: E402
from caffe_escoin_tpu_torch.nn import (LayerSpec, Net,  # noqa: E402
                                       fuse_inference, params_from_jax)
from caffe_escoin_tpu_torch.nn.fuse import (fold_stem_s2d,  # noqa: E402
                                            pack_narrow_chains)
from caffe_escoin_tpu_torch.utils import pruning  # noqa: E402

BLOCK = (8, 8)
SPARSITY = 0.75
TOL = dict(rtol=1e-4, atol=1e-5)
# (name, out_1x1, reduce_3x3, out_3x3, reduce_5x5, out_5x5, pool_proj)
CFG = [("3a", 8, 8, 16, 4, 8, 8), ("3b", 16, 16, 24, 8, 16, 8)]
NETS = {"googlenet": (2, 64, 64, 3), "alexnet": (2, 67, 67, 3)}


def _lrn(spec, name, bottom):
    return spec(name, "LRN", (bottom,),
                params=dict(local_size=5, alpha=1e-4, beta=0.75))


def _small_googlenet(spec, m):
    """GoogLeNet's structure from the package ``m``'s own helpers."""
    specs = [
        m._conv("conv1/7x7_s2", "data", 16, 7, s=2, p=3),
        spec("pool1/3x3_s2", "Pooling", ("conv1/7x7_s2",),
             params=dict(kernel=3, stride=2)),
        _lrn(spec, "pool1/norm1", "pool1/3x3_s2"),
        m._conv("conv2/3x3_reduce", "pool1/norm1", 16, 1),
        m._conv("conv2/3x3", "conv2/3x3_reduce", 32, 3, p=1),
        _lrn(spec, "conv2/norm2", "conv2/3x3"),
        spec("pool2/3x3_s2", "Pooling", ("conv2/norm2",),
             params=dict(kernel=3, stride=2)),
    ]
    bottom = "pool2/3x3_s2"
    for cfg in CFG:
        specs += m._inception(cfg[0], bottom, cfg)
        bottom = f"inception_{cfg[0]}/output"
    return specs + [
        spec("pool5/7x7_s1", "Pooling", (bottom,),
             params=dict(mode="avg", global_pooling=True)),
        spec("pool5/drop_7x7_s1", "Dropout", ("pool5/7x7_s1",),
             tops=("pool5d",), params=dict(ratio=0.4)),
        spec("loss3/classifier", "InnerProduct", ("pool5d",),
             params=dict(num_output=10)),
        spec("prob", "Softmax", ("loss3/classifier",)),
    ]


def _small_alexnet(spec, m=None):
    """AlexNet's pattern (models/alexnet.py), narrow: the grouped convs
    keep its groups."""
    def conv(name, bottom, cout, k, s=1, p=0, group=1):
        return spec(name, "ConvolutionReLU", (bottom,),
                    params=dict(num_output=cout, kernel=k, stride=s, pad=p,
                                group=group))

    return [
        conv("conv1", "data", 16, 11, s=4),
        _lrn(spec, "norm1", "conv1"),
        spec("pool1", "Pooling", ("norm1",), params=dict(kernel=3, stride=2)),
        conv("conv2", "pool1", 32, 5, p=2, group=2),
        _lrn(spec, "norm2", "conv2"),
        spec("pool2", "Pooling", ("norm2",), params=dict(kernel=3, stride=2)),
        conv("conv3", "pool2", 32, 3, p=1),
        conv("conv4", "conv3", 32, 3, p=1, group=2),
        spec("fc6", "InnerProduct", ("conv4",), params=dict(num_output=10)),
        spec("prob", "Softmax", ("fc6",)),
    ]


BUILD = {"googlenet": (_small_googlenet, googlenet, jgooglenet),
         "alexnet": (_small_alexnet, None, None)}


def _prune(specs, params, prune_conv, prune_blocks, asarray):
    out = dict(params)
    for s in specs:
        if s.name not in out or "w" not in out[s.name]:
            continue
        q = dict(out[s.name])
        w = np.asarray(q["w"])
        if w.ndim == 2:
            wp = prune_blocks(w, SPARSITY, BLOCK)
        elif w.shape[2] >= 8:
            wp = prune_conv(w, SPARSITY, BLOCK)
        else:
            continue
        q["w"] = asarray(wp * np.float32(np.linalg.norm(w)
                                         / np.linalg.norm(wp)))
        out[s.name] = q
    return out


POLICIES = {  # path -> (port policy, JAX policy)
    "dense": (ExecutionPolicy(), JPolicy()),
    "kernel_routes": (
        ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                        use_xla_sparse=False),
        JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=BLOCK,
                use_pallas=True, interpret=True, mxu_dtype="float32",
                use_xla_sparse=False, spmm_tile_m=64)),
    "xbsp": (ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK),
             JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=BLOCK)),
}


def _nets(name, path):
    """Both sides' pruned, fused nets on the same params under ``path``."""
    build, mod, jmod = BUILD[name]
    pol, jpol = POLICIES[path]
    shape = NETS[name]
    jnet = JNet(build(JLayerSpec, jmod), policy=jpol, phase="test")
    jparams = jnet.init(jax.random.PRNGKey(0), {"data": shape})
    np_params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                 for k, v in jparams.items()}
    net = Net(build(LayerSpec, mod), policy=pol)
    net.init(torch.Generator().manual_seed(0), {"data": shape})
    params, _ = params_from_jax(np_params)
    jpruned = _prune(jnet.specs, np_params, jpruning.prune_conv_weight,
                     jpruning.prune_blocks, jnp.asarray)
    pruned = _prune(net.specs, params, pruning.prune_conv_weight,
                    pruning.prune_blocks, torch.from_numpy)
    jfnet, jfparams = jfuse(jnet, jpruned, state=jnet.state0)
    fnet, fparams = fuse_inference(net, pruned)
    return (fnet, fparams), (jfnet, jfparams)


def _x(name, seed=0):
    return np.random.default_rng(seed).standard_normal(NETS[name]).astype(
        np.float32)


def _run(net, params, jnet, jparams, path, x):
    if path != "dense":
        params, jparams = net.weight_align(params), jnet.weight_align(jparams)
    got = net.apply(params, {"data": torch.from_numpy(x)}, return_blobs=True)
    want = jnet.apply(jparams, {"data": jnp.asarray(x)}, return_blobs=True)
    return got, want, params


@pytest.mark.parametrize("path", list(POLICIES))
@pytest.mark.parametrize("name", list(NETS))
def test_whole_net_matches_jax(name, path):
    (fnet, fparams), (jfnet, jfparams) = _nets(name, path)
    sconv_fused.reset_counts()
    bsc_spmm.reset_counts()
    got, want, aligned = _run(fnet, fparams, jfnet, jfparams, path, _x(name))
    assert set(got) <= set(want)
    for k, blob in got.items():
        if k == "data":
            continue
        np.testing.assert_allclose(blob.numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert np.abs(got["prob"].sum(-1).numpy() - 1).max() < 1e-5
    if path != "kernel_routes":
        return
    routes = fnet.routes(aligned, {"data": NETS[name]})
    fused = [k for k, r in routes.items() if r == "fused"]
    # each fused route ran the kernel entry (its plain version on the CPU)
    assert sconv_fused.calls == len(fused) and bsc_spmm.calls >= 1
    if name == "alexnet":
        # the grouped convs on their block-diagonal weights
        assert routes == dict(conv1="dense", conv2="fused", conv3="fused",
                              conv4="fused", fc6="spmm")
    else:
        assert routes["conv1/7x7_s2"] == "dense"
        assert routes["loss3/classifier"] == "spmm"
        assert len(fused) >= 8


@pytest.mark.parametrize("path", ["dense", "kernel_routes", "xbsp"])
def test_stem_transforms_keep_the_logits(path):
    """GoogLeNet as bench.py runs it: fused, then the s2d stem fold, then the
    packed layout (at lanes=32, so that these narrow towers pack). Each
    form gives the fused net's logits, and the JAX package's for the same
    form."""
    (fnet, fparams), (jfnet, jfparams) = _nets("googlenet", path)
    x = _x("googlenet", seed=1)
    snet, sparams = fold_stem_s2d(fnet, fparams)
    jsnet, jsparams = jfold(jfnet, jfparams)
    assert snet.specs[0].params["s2d_r"] == 2
    pnet = pack_narrow_chains(snet, lanes=32)
    jpnet = jpack(jsnet, lanes=32)
    assert pnet.packed_blobs == jpnet.packed_blobs
    assert "pool1/norm1" in pnet.packed_blobs
    assert "conv1/7x7_s2" not in pnet.packed_blobs
    base, _, _ = _run(fnet, fparams, jfnet, jfparams, path, x)
    logits = "loss3/classifier"
    for net, params, jnet, jparams in ((snet, sparams, jsnet, jsparams),
                                       (pnet, sparams, jpnet, jsparams)):
        got, want, _ = _run(net, params, jnet, jparams, path, x)
        np.testing.assert_allclose(got[logits].numpy(),
                                   base[logits].numpy(), **TOL)
        np.testing.assert_allclose(got[logits].numpy(),
                                   np.asarray(want[logits]), **TOL)


def test_kernel_routes_reach_the_fused_kernel_on_both_sides(monkeypatch):
    """The small GoogLeNet's sparse convs take the fused kernel in the JAX
    dispatcher too, so the kernel-route case compares kernel with kernel."""
    calls = []
    real = jsconv_fused.sconv
    monkeypatch.setattr(jsconv_fused, "sconv",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    (fnet, fparams), (jfnet, jfparams) = _nets("googlenet", "kernel_routes")
    aligned = fnet.weight_align(fparams)
    routes = fnet.routes(aligned, {"data": NETS["googlenet"]})
    jfnet.apply(jfnet.weight_align(jfparams),
                {"data": jnp.asarray(_x("googlenet"))})
    assert len(calls) == sum(r == "fused" for r in routes.values())
