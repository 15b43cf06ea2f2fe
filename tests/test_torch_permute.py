"""The port's channel permutation (sparse/permute.py) and block
densification (utils/pruning.densify_blocks) against the JAX package's, on
the same numpy inputs made from a seed: the permutations, the stats, the
report and the deployed params must be identical (numpy on both sides).
The counterparts of tests/test_permute_densify.py, plus
``find_permutable_pairs`` and ``deploy_unstructured`` on the ZOO's nets."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.ops.conv import conv2d_dense as jconv  # noqa: E402
from caffe_escoin_tpu.sparse import permute as jpermute  # noqa: E402
from caffe_escoin_tpu.utils import pruning as jpruning  # noqa: E402

from caffe_escoin_tpu_torch.models import ZOO  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net  # noqa: E402
from caffe_escoin_tpu_torch.ops.conv import conv2d_dense  # noqa: E402
from caffe_escoin_tpu_torch.sparse import permute  # noqa: E402
from caffe_escoin_tpu_torch.utils import pruning  # noqa: E402


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


def _sparse_matrix(seed, shape, keep):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[rng.random(w.shape) >= keep] = 0
    return w


def _planted(seed=1, cin=32, cout=32, bk=8, bn=8):
    rng = np.random.default_rng(seed)
    w = np.zeros((cin, cout), np.float32)
    for bi in range(cin // bk):
        bj = rng.integers(0, cout // bn)
        w[bi * bk:(bi + 1) * bk, bj * bn:(bj + 1) * bn] = rng.standard_normal(
            (bk, bn))
    return w[rng.permutation(cin)][:, rng.permutation(cout)]


@pytest.mark.parametrize("case", ["offsets", "planted", "cout_only",
                                  "wide_blocks"])
def test_block_permutation_is_the_jax_permutation(case):
    """Identical (cin_perm, cout_perm, stats); values and counts kept."""
    kw = {}
    if case == "offsets":
        wmat, block, kw = _sparse_matrix(0, (32, 24), 0.2), (8, 8), dict(
            kernel_offsets=2)
    elif case == "planted":
        wmat, block, kw = _planted(), (8, 8), dict(passes=3)
    elif case == "cout_only":
        wmat, block, kw = _sparse_matrix(5, (72, 40), 0.15), (8, 8), dict(
            kernel_offsets=9, optimize_rows=False)
    else:
        wmat, block = _sparse_matrix(6, (64, 48), 0.1), (16, 16)
    got = permute.block_permutation(wmat, block, **kw)
    _same(got, jpermute.block_permutation(wmat, block, **kw))
    cin_perm, cout_perm, stats = got
    off = kw.get("kernel_offsets", 1)
    k, n = wmat.shape
    w2 = wmat.reshape(off, k // off, n)[:, cin_perm][:, :, cout_perm]
    assert sorted(wmat.ravel()) == sorted(w2.ravel())
    assert stats["blocks_after"] <= stats["blocks_before"]
    assert permute._live_blocks(w2.reshape(k, n) != 0, *block) == \
        stats["blocks_after"]


def test_permutation_recovers_planted_block_structure():
    w = _planted()
    planted_blocks = 4  # one live block per row-block
    before = permute._live_blocks(w != 0, 8, 8)
    assert before > planted_blocks
    _, _, stats = permute.block_permutation(w, (8, 8), passes=3)
    assert stats["blocks_after"] <= planted_blocks * 2
    assert stats["blocks_after"] < before


def test_permuted_conv_matches_jax_and_the_channel_shuffled_oracle():
    """Permuting (cin, cout) of a conv weight == permuting the input's and
    output's channel dims, on the port's dense conv, and == the JAX
    result (rtol 1e-5, as the JAX test)."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 3, 8, 12)).astype(np.float32)
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    cin_perm = rng.permutation(8)
    cout_perm = rng.permutation(12)
    w2 = permute.permute_conv_weight(w, cin_perm, cout_perm)
    np.testing.assert_array_equal(
        w2, jpermute.permute_conv_weight(w, cin_perm, cout_perm))
    xt = torch.from_numpy(x)
    out2 = conv2d_dense(xt[..., cin_perm], torch.from_numpy(w2),
                        padding=(1, 1)).numpy()
    ref = conv2d_dense(xt, torch.from_numpy(w), padding=(1, 1)).numpy()
    np.testing.assert_allclose(out2, ref[..., cout_perm], rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(jconv(jnp.asarray(x[..., cin_perm]), jnp.asarray(w2),
                            padding=(1, 1)))
    np.testing.assert_allclose(out2, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("min_density", [0.0, 0.15])
def test_densify_blocks_is_the_jax_densify(min_density):
    w = _sparse_matrix(3, (32, 32), 0.1)
    out, stats = pruning.densify_blocks(w, (8, 8), min_density)
    jout, jstats = jpruning.densify_blocks(w, (8, 8), min_density)
    np.testing.assert_array_equal(out, jout)
    assert stats == jstats
    kept = out != 0
    assert (out[kept] == w[kept]).all()
    dens = kept.reshape(4, 8, 4, 8).transpose(0, 2, 1, 3).mean(axis=(2, 3))
    assert ((dens == 0) | (dens >= min_density)).all()
    if min_density == 0.0:
        np.testing.assert_array_equal(out, w)
        assert stats["extra_zeroed_frac"] == 0.0


def test_layer_types_are_in_the_port_registry():
    from caffe_escoin_tpu_torch.nn.net import LAYER_REGISTRY

    assert permute.CHANNEL_PRESERVING == jpermute.CHANNEL_PRESERVING
    assert permute._WEIGHT_TYPES == jpermute._WEIGHT_TYPES
    assert set(permute.CHANNEL_PRESERVING) | set(permute._WEIGHT_TYPES) <= \
        set(LAYER_REGISTRY)


@pytest.mark.parametrize("model", ["lenet", "cifar10_quick", "alexnet",
                                   "resnet50"])
def test_find_permutable_pairs_is_the_jax_list(model):
    pairs = permute.find_permutable_pairs(Net(ZOO[model][0]()))
    jpairs = jpermute.find_permutable_pairs(JNet(JZOO[model][0]()))
    assert [(p.spec.name, c.spec.name) for p, c in pairs] == \
        [(p.spec.name, c.spec.name) for p, c in jpairs]


def _unstructured(model, shape, block):
    """The JAX net's params, every conv and fc weight pruned element-wise
    to 90% (numpy), and the port's net built from the same specs."""
    jnet = JNet(JZOO[model][0]())
    params = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), {"data": shape}))
    for name, p in params.items():
        if "w" in p:
            p["w"] = jpruning.prune_magnitude(p["w"], 0.9)
    net = Net(ZOO[model][0](), device="cpu")
    net.init(torch.Generator().manual_seed(0), {"data": shape})
    return jnet, net, params


@pytest.mark.parametrize("model,shape,block", [
    ("lenet", (2, 28, 28, 1), (8, 8)),
    ("cifar10_quick", (2, 32, 32, 3), (16, 16)),
])
@pytest.mark.parametrize("min_density", [0.0, 0.05])
def test_deploy_unstructured_is_the_jax_deployment(model, shape, block,
                                                   min_density):
    """The same report and the same params, the port's as tensors of the
    old ones' dtype; at min_density 0 the deployment is lossless: the
    permuted net's output equals the unpermuted one's."""
    jnet, net, params = _unstructured(model, shape, block)
    jout, jreport = jpermute.deploy_unstructured(
        jnet, params, block_shape=block, min_density=min_density)
    tparams = {n: {k: torch.from_numpy(v.copy()) for k, v in p.items()}
               for n, p in params.items()}
    logs = []
    out, report = permute.deploy_unstructured(
        net, tparams, block_shape=block, min_density=min_density,
        log=logs.append)
    assert report == jreport
    assert report["permuted"]  # the nets have pairs the greedy pass helps
    assert len(logs) == len(report["permuted"]) + len(report["densified"])
    assert sorted(out) == sorted(jout)
    for name, p in jout.items():
        for k, v in p.items():
            assert out[name][k].dtype == torch.float32
            np.testing.assert_array_equal(out[name][k].numpy(),
                                          np.asarray(v))
    if min_density == 0.0:
        x = {"data": torch.from_numpy(np.random.default_rng(0).standard_normal(
            shape).astype(np.float32))}
        with torch.inference_mode():
            got = net.apply(out, x)["prob"]
            want = net.apply(tparams, x)["prob"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_deploy_unstructured_keeps_the_params_dtype():
    """bf16 params come back bf16 (numpy has no bf16: the host copy is
    f32), with the JAX deployment's values rounded once."""
    jnet, net, params = _unstructured("lenet", (2, 28, 28, 1), (8, 8))
    tparams = {n: {k: torch.from_numpy(v.copy()).bfloat16()
                   for k, v in p.items()} for n, p in params.items()}
    host = {n: {k: v.float().numpy() for k, v in p.items()}
            for n, p in tparams.items()}
    jout, _ = jpermute.deploy_unstructured(jnet, host, block_shape=(8, 8))
    out, _ = permute.deploy_unstructured(net, tparams, block_shape=(8, 8))
    for name, p in jout.items():
        for k, v in p.items():
            assert out[name][k].dtype == torch.bfloat16
            np.testing.assert_array_equal(out[name][k].float().numpy(),
                                          np.asarray(v))


def test_fused_resnet_pairs_skip_the_residual_adds():
    """On a fused narrow ResNet, whose convs add the residual as a second
    bottom: the port's pairs are the JAX function's less those that would
    permute a residual (a producer that adds one, or a blob reaching its
    consumer as the residual), and the deployment at min_density 0 is
    lossless."""
    from caffe_escoin_tpu.models import resnet as jresnet
    from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse

    from caffe_escoin_tpu.nn.net import LayerSpec as JLayerSpec
    from test_torch_net import SHAPES, _narrow_resnet

    from caffe_escoin_tpu_torch.models import resnet
    from caffe_escoin_tpu_torch.nn import LayerSpec, fuse_inference

    jnet = JNet(_narrow_resnet(jresnet._conv_bn, jresnet._bottleneck,
                               JLayerSpec))
    jparams = jnet.init(jax.random.PRNGKey(0), SHAPES)
    jfnet, _ = jfuse(jnet, jparams, state=jnet.state0)
    net = Net(_narrow_resnet(resnet._conv_bn, resnet._bottleneck, LayerSpec))
    params = net.init(torch.Generator().manual_seed(0), SHAPES)
    for p in params.values():
        if "w" in p:
            p["w"] = torch.from_numpy(pruning.prune_magnitude(
                p["w"].numpy(), 0.9))
    fnet, fparams = fuse_inference(net, params, state=net.state0)
    got = [(a.spec.name, b.spec.name)
           for a, b in permute.find_permutable_pairs(fnet)]
    jpairs = jpermute.find_permutable_pairs(jfnet)
    want = [(a.spec.name, b.spec.name) for a, b in jpairs
            if len(a.spec.bottoms) == 1
            and b.spec.bottoms[0] == a.spec.tops[0]]
    assert got == want and len(want) < len(jpairs)
    out, report = permute.deploy_unstructured(fnet, fparams,
                                              block_shape=(8, 8),
                                              min_density=0.0)
    assert report["permuted"]
    x = {"data": torch.from_numpy(np.random.default_rng(0).standard_normal(
        SHAPES["data"]).astype(np.float32))}
    with torch.inference_mode():
        a = fnet.apply(fparams, x, return_blobs=True)["fc"]
        b = fnet.apply(out, x, return_blobs=True)["fc"]
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)
