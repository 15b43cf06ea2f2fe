"""Port parity for the whole slice: a narrow ResNet built from the same
``_conv_bn`` / ``_bottleneck`` helpers on both sides is initialised by the
JAX package, carried over with ``params_from_jax``, pruned, fused and
weight-aligned on both sides, and run: the port's plain routes against JAX
``Net.apply`` with its Pallas kernels in interpret mode. rtol 1e-4,
atol 1e-5 (f32 on both sides, sums in another order)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.models import resnet as jresnet  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JLayerSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.utils import pruning as jpruning  # noqa: E402

from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import bsc_spmm, sconv_fused  # noqa: E402
from caffe_escoin_tpu_torch.models import resnet  # noqa: E402
from caffe_escoin_tpu_torch.nn import (LayerSpec, Net, fuse_inference,  # noqa: E402
                                       params_from_jax)
from caffe_escoin_tpu_torch.utils import pruning  # noqa: E402

BLOCK = (16, 16)
SPARSITY = 0.75
SHAPES = {"data": (2, 32, 32, 3)}
TOL = dict(rtol=1e-4, atol=1e-5)


def _narrow_resnet(conv_bn, bottleneck, spec):
    """Stem 7x7/s2 to 16, pool, two stages of two bottlenecks (16->32 s1,
    16->64 s2), global average pool, fc 24, softmax."""
    specs, top = conv_bn("conv1", "data", 16, 7, s=2, p=3)
    specs.append(spec("pool1", "Pooling", (top,),
                      params=dict(kernel=3, stride=2)))
    top = "pool1"
    for stage, mid, cout, stride in (("2", 16, 32, 1), ("3", 16, 64, 2)):
        for i in range(2):
            blk, top = bottleneck(stage, i, top, mid, cout,
                                  stride if i == 0 else 1)
            specs += blk
    specs += [
        spec("pool5", "Pooling", (top,),
             params=dict(mode="avg", global_pooling=True)),
        spec("fc", "InnerProduct", ("pool5",),
             params=dict(num_output=24, weight_filler={"type": "xavier"})),
        spec("prob", "Softmax", ("fc",)),
    ]
    return specs


def _prune(specs, params, prune_conv, prune_blocks, asarray):
    """Prune conv weights (not the 3-channel stem) and fc weights."""
    out = dict(params)
    for s in specs:
        if s.name not in out or s.type not in ("Convolution", "InnerProduct"):
            continue
        q = dict(out[s.name])
        w = np.asarray(q["w"])
        if s.type == "Convolution":
            if w.shape[2] < 8:
                continue
            q["w"] = asarray(prune_conv(w, SPARSITY, BLOCK))
        else:
            q["w"] = asarray(prune_blocks(w, SPARSITY, BLOCK))
        out[s.name] = q
    return out


@pytest.fixture(scope="module")
def slice_run():
    jpol = JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=BLOCK,
                   use_pallas=True, interpret=True, mxu_dtype="float32",
                   use_xla_sparse=False)
    jnet = JNet(_narrow_resnet(jresnet._conv_bn, jresnet._bottleneck,
                               JLayerSpec), policy=jpol, phase="test")
    jparams = jnet.init(jax.random.PRNGKey(0), SHAPES)
    # non-trivial BatchNorm statistics and Scale affine, so the fold does
    # real work (init leaves count 0, gamma 1, beta 0)
    rng = np.random.default_rng(0)
    jstate = {}
    for name, st in jnet.state0.items():
        c = st["mean_acc"].shape[0]
        jstate[name] = {
            "mean_acc": rng.standard_normal(c).astype(np.float32) * 0.2,
            "var_acc": rng.uniform(1.0, 3.0, c).astype(np.float32),
            "count": np.float32(2.0)}
    jparams = {k: dict(v) for k, v in jparams.items()}
    for s in jnet.specs:
        if s.type == "Scale":
            c = jparams[s.name]["gamma"].shape[0]
            jparams[s.name]["gamma"] = jnp.asarray(
                rng.uniform(0.5, 1.5, c).astype(np.float32))
            jparams[s.name]["beta"] = jnp.asarray(
                rng.standard_normal(c).astype(np.float32) * 0.1)
    np_params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                 for k, v in jparams.items()}

    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                          use_xla_sparse=False)
    net = Net(_narrow_resnet(resnet._conv_bn, resnet._bottleneck, LayerSpec),
              policy=pol)
    init_params = net.init(torch.Generator().manual_seed(0), SHAPES)
    params, state = params_from_jax(np_params, jstate)

    jpruned = _prune(jnet.specs, np_params, jpruning.prune_conv_weight,
                     jpruning.prune_blocks, jnp.asarray)
    pruned = _prune(net.specs, params, pruning.prune_conv_weight,
                    pruning.prune_blocks, torch.from_numpy)
    jfnet, jfparams = jfuse(jnet, jpruned, state=jstate)
    fnet, fparams = fuse_inference(net, pruned, state=state)
    jaligned = jfnet.weight_align(jfparams)
    aligned = fnet.weight_align(fparams)

    x = np.random.default_rng(1).standard_normal(SHAPES["data"]).astype(
        np.float32)
    # the unfused graphs (BatchNorm, Scale, ReLU, Eltwise layers) on the
    # pruned dense weights
    junfused = jnet.apply(jpruned, {"data": jnp.asarray(x)}, state=jstate,
                          return_blobs=True)
    unfused = net.apply(pruned, {"data": torch.from_numpy(x)}, state=state,
                        return_blobs=True)
    jblobs = jfnet.apply(jaligned, {"data": jnp.asarray(x)},
                         return_blobs=True)
    sconv_fused.reset_counts()
    bsc_spmm.reset_counts()
    blobs = fnet.apply(aligned, {"data": torch.from_numpy(x)},
                       return_blobs=True)
    counts = dict(sconv_calls=sconv_fused.calls,
                  sconv_launches=sconv_fused.launches,
                  spmm_calls=bsc_spmm.calls, spmm_launches=bsc_spmm.launches)
    return dict(jnet=jnet, net=net, jfnet=jfnet, fnet=fnet, aligned=aligned,
                jblobs=jblobs, blobs=blobs, counts=counts, pol=pol,
                junfused=junfused, unfused=unfused, init_params=init_params,
                np_params=np_params, init_state=net.state0,
                jinit_state=jnet.state0)


@pytest.mark.parametrize("blob", ["fc", "prob"])
def test_slice_matches_jax_apply(slice_run, blob):
    out = slice_run["blobs"][blob].numpy()
    ref = np.asarray(slice_run["jblobs"][blob])
    assert out.shape == ref.shape == ((2, 24))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("blob", ["fc", "prob"])
def test_unfused_graph_matches_jax_and_fused(slice_run, blob):
    """The unfused layers (BatchNorm at the carried-over statistics, Scale,
    ReLU, Eltwise) against JAX, and the fold against the unfused graph."""
    out = slice_run["unfused"][blob].numpy()
    np.testing.assert_allclose(out, np.asarray(slice_run["junfused"][blob]),
                               **TOL)
    np.testing.assert_allclose(slice_run["blobs"][blob].numpy(), out, **TOL)


def test_init_matches_jax_shapes(slice_run):
    """The port's own init (torch.Generator fillers) gives every layer the
    JAX package's parameter and BatchNorm-state names and shapes."""
    def shapes(tree):
        return {k: {kk: tuple(np.shape(vv)) for kk, vv in v.items()}
                for k, v in tree.items()}

    assert shapes(slice_run["init_params"]) == shapes(slice_run["np_params"])
    assert shapes(slice_run["init_state"]) == shapes(slice_run["jinit_state"])


def test_fused_graph_matches_jax(slice_run):
    def layout(n):
        return [(s.name, s.type, s.bottoms, s.tops,
                 {k: v for k, v in s.params.items()}) for s in n.specs]

    assert len(slice_run["jnet"].specs) == len(slice_run["net"].specs) == 66
    assert len(slice_run["fnet"].specs) == 19
    assert layout(slice_run["fnet"]) == layout(slice_run["jfnet"])


def test_every_sparse_layer_took_the_kernel_entries(slice_run):
    aligned, pol = slice_run["aligned"], slice_run["pol"]
    sparse_convs = [s.name for s in slice_run["fnet"].specs
                    if s.type == "Convolution"
                    and aligned[s.name].bsc is not None
                    and aligned[s.name].sparsity >= pol.sconv_threshold]
    assert len(sparse_convs) == 13
    # CPU tensors: the entries ran their plain versions, no kernel launched
    assert slice_run["counts"] == dict(
        sconv_calls=len(sparse_convs), sconv_launches=0, spmm_calls=1,
        spmm_launches=0)


def test_inference_fn_graph_form_runs_cpu_inputs_eagerly(slice_run):
    """The CUDA-graph form captures only CUDA inputs; on the CPU it is the
    eager forward (the card tests hold its replays)."""
    x = np.random.default_rng(1).standard_normal(SHAPES["data"]).astype(
        np.float32)
    fwd = slice_run["fnet"].inference_fn(slice_run["aligned"],
                                         cuda_graph=True)
    for _ in range(2):
        out = fwd({"data": torch.from_numpy(x)})
        np.testing.assert_array_equal(out["prob"].numpy(),
                                      slice_run["blobs"]["prob"].numpy())
