"""Multiplying in f32 (``mxu_dtype="float32"``) in the three hand kernels,
checked on the CPU.

* The launch plans (``kernels/sconv_pipe.py``) of every layer that takes a
  kernel in VGG-16 at b16 and ResNet-50 at b32 run in f32 (weights pruned to
  90% in 128x128 blocks, f32 activations, routes from ``Net.routes``): each
  fits the shared memory one block may use on an H100 with two blocks per
  SM, steps 32 values (128 bytes) deep, and the C entry's integer array
  carries it.
* The operands as the f32 kernels copy them (``kernel_operands`` with
  ``mul="float32"``): never rounded (a bf16 activation or weight is
  widened, exactly), channels and K-blocks padded to multiples of 4, and
  the padded operands compute the conv and the product of the unpadded
  ones within f32 rounding (a bf16 rounding would miss by ~1e-2).
* The autotune key: a bf16-multiply key is the key as it was, byte for
  byte; an f32-multiply key differs from it.
* A narrow VGG-16 (the slice of ``test_torch_vgg.py``: fused, gc and the
  SpMM all reached) with ``mxu_dtype="float32"`` against the JAX package
  with its Pallas kernels in interpret mode and ``mxu_dtype="float32"``
  (as ``tests/test_sconv_fused.py`` runs them): every blob within 1e-5
  relative L2 (f32 on both sides, sums in another order).

The kernels themselves, in f32 against their plain versions in f64, are in
``test_torch_cuda.py`` (marked ``cuda``).
"""

import ast
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_fused as jsconv_fused  # noqa: E402
from caffe_escoin_tpu.kernels import sconv_pallas as jsconv_pallas  # noqa: E402
from caffe_escoin_tpu.models import vgg as jvgg  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.utils import pruning as jpruning  # noqa: E402

from caffe_escoin_tpu_torch.engine import autotune  # noqa: E402
from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import (bsc_spmm, sconv_fused,  # noqa: E402
                                            sconv_gc, sconv_pipe)
from caffe_escoin_tpu_torch.models import ZOO, vgg  # noqa: E402
from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_from_jax  # noqa: E402
from caffe_escoin_tpu_torch.ops import conv as conv_ops  # noqa: E402
from caffe_escoin_tpu_torch.sparse import dense_to_bsc  # noqa: E402
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils import pruning  # noqa: E402
import test_torch_vgg as tvgg  # noqa: E402

BLOCK = (128, 128)
SPARSITY = 0.9
BATCH = {"vgg16": 16, "resnet50": 32}
# the routes each net takes with f32 activations: the reference's size
# gates count 4-byte items, so more layers leave sconv_gc and the fused
# kernel than in bf16 (VGG-16 b16 conv2_2 goes lowered; some of ResNet-50
# b32's 1x1s go to the SpMM, how many depends on the pruned pattern's
# max_bw)
F32_ROUTES = {
    "vgg16": {"dense", "lowered", "gc", "fused", "spmm"},
    "resnet50": {"dense", "fused", "spmm_1x1", "spmm"},
}
NET_REL_L2 = 1e-5


@pytest.fixture(scope="module", params=list(BATCH))
def f32_layers(request):
    """(model, [(name, route, block width, launch plan, the plan as the C
    entry's integer array holds it)]) for every conv and fc that takes a
    kernel in f32. Weights are random and pruned; only shapes and block
    counts matter here."""
    model = request.param
    build, shapes = ZOO[model]
    shapes = {"data": (BATCH[model],) + tuple(shapes["data"][1:])}
    net = Net(build(), policy=ExecutionPolicy(
        conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK, use_xla_sparse=False,
        mxu_dtype="float32"))
    rng = np.random.default_rng(0)
    aligned, geo = {}, {}
    for layer, in_shapes in net.walk_shapes(shapes):
        spec = layer.spec
        p = spec.params
        if spec.type == "InnerProduct":
            k = int(np.prod(in_shapes[0][1:]))
            w = pruning.prune_blocks(rng.standard_normal(
                (k, p["num_output"])).astype(np.float32), SPARSITY, BLOCK)
            aligned[spec.name] = weight_align(w[None, None],
                                              policy=net.policy)
            geo[spec.name] = ((in_shapes[0][0],), None)
            continue
        if spec.type not in ("Convolution", "ConvolutionReLU"):
            continue
        k, cin = p["kernel"], in_shapes[0][-1]
        w = rng.standard_normal((k, k, cin, p["num_output"])).astype(
            np.float32)
        if cin >= 32:
            w = pruning.prune_conv_weight(w, SPARSITY, BLOCK)
        aligned[spec.name] = weight_align(w, policy=net.policy)
        n, h, wd, c = in_shapes[0]
        s, pad = p.get("stride", 1), p.get("pad", 0)
        if s != 1 and k == 1:  # runs on the subsampled map
            h, wd = (h + 2 * pad - 1) // s + 1, (wd + 2 * pad - 1) // s + 1
            pad = 0
        geo[spec.name] = ((n, h, wd, c), (pad, pad))
    routes = net.routes(aligned, shapes)
    assert set(routes.values()) == F32_ROUTES[model]
    assert len(routes) == {"vgg16": 16, "resnet50": 54}[model]
    out = []
    for name, route in routes.items():
        if route in ("fused", "gc"):
            al, (x_shape, pad) = aligned[name], geo[name]
            mod = sconv_fused if route == "fused" else sconv_gc
            plan = mod.launch_plan(x_shape, al, pad, "float32")
            meta = torch.empty(x_shape, dtype=torch.float32, device="meta")
            xk, _, bk = sconv_pipe.kernel_operands(meta, al, "float32")
            if route == "fused":
                dims = sconv_fused._dims(x_shape, xk.shape[-1], bk, al, pad,
                                         True, False, "float32")
            else:
                n_cin_b = al.cin_pad // al.bsc.block_shape[0]
                slab = sconv_gc._kernel_slab(xk, pad, n_cin_b * bk)
                dims = sconv_gc._dims(x_shape, slab.shape, bk, al, pad, True,
                                      False, "float32")
            out.append((name, route, al.bsc.block_shape[1], plan,
                        list(dims)[-4:]))
        elif route == "spmm":
            out.append(_spmm_case(name, route, geo[name][0][0],
                                  aligned[name].bsc))
        elif route in ("lowered", "spmm_1x1"):
            al, (x_shape, pad) = aligned[name], geo[name]
            kh, kw = al.kernel_shape
            n, h, wd, _ = x_shape
            m = n * (h + 2 * pad[0] - kh + 1) * (wd + 2 * pad[1] - kw + 1)
            out.append(_spmm_case(name, route, m, al.bsc))
    return model, out


def _spmm_case(name, route, m, bsc):
    plan = bsc_spmm.launch_plan(m, bsc, "float32")
    bk, bn = bsc.block_shape
    got, dims = bsc_spmm._launch(m, bsc.shape[0], bsc.shape[1], bk, bn,
                                 bsc.n_bcols, bsc.max_bw, 1, 0, "float32")
    assert got == plan, name
    return name, route, bn, plan, list(dims)[9:13]


def test_f32_plans_fit_shared_memory(f32_layers):
    """Every f32 plan of the two nets fits 227 KB per block, two blocks per
    SM, with steps 32 values deep; the C entry gets that plan."""
    model, layers = f32_layers
    assert {r for _, r, _, _, _ in layers} == F32_ROUTES[model] - {"dense"}
    for name, route, bn, p, dims in layers:
        bn_t = sconv_pipe.bn_tile(bn)
        assert p.chunk == sconv_pipe.chunk_of("float32") == 32, name
        assert p.smem == sconv_pipe.smem_bytes(p.tile_m, bn_t, p.stages,
                                               "float32"), name
        assert p.smem <= sconv_pipe.SMEM_PER_BLOCK, name
        assert 2 * (p.smem + sconv_pipe.SMEM_RESERVED) <= \
            sconv_pipe.SMEM_PER_SM, name
        assert p.tile_m in (64, 128) and 2 <= p.stages <= 4, name
        assert dims == [p.tile_m, p.stages, p.chunk, p.smem], name


def test_f32_split_covers_every_live_slot_once(f32_layers):
    """Split-K in f32 (the fc layers, and the SpMM's small-M 1x1s):
    every slot of every column in exactly one share."""
    _, layers = f32_layers
    split = [(n, p) for n, r, _, p, _ in layers if p.split > 1]
    assert "fc6" in dict(split) or "fc1000" in dict(split)
    for name, p in split:
        assert p.tile_m == 64 and p.share >= 1, name
        seen = {}
        for b in range(p.grid):
            for s in p.slots(b, p.split * p.share):
                j = p.block(b)[3]
                seen[(j, s)] = seen.get((j, s), 0) + 1
        assert set(seen.values()) == {p.m_tiles}, name


def test_f32_stage_bytes_equal_bf16_stage_bytes():
    """A stage is 128 bytes of a row deep in both types: the same shared
    bytes, so an f32 K-block takes twice the steps and may get a deeper
    ring from the same budget."""
    for tile_m in (64, 128):
        for bn_t in (32, 64, 128):
            for stages in (2, 3, 4):
                assert sconv_pipe.smem_bytes(tile_m, bn_t, stages) == \
                    sconv_pipe.smem_bytes(tile_m, bn_t, stages, "float32")
    # one live 128-deep K-block: 2 steps in bf16, 4 in f32
    p16 = sconv_pipe.plan(1, 32 * 7 * 7, (128, 64), 2, 1)
    p32 = sconv_pipe.plan(1, 32 * 7 * 7, (128, 64), 2, 1, "float32")
    assert (p16.chunk, p32.chunk) == (64, 32)
    assert (p16.tile_m, p16.stages, p32.stages) == (64, 2, 4)


def _aligned(rng, cin, cout, k, block):
    wt = pruning.prune_conv_weight(rng.standard_normal(
        (k, k, cin, cout)).astype(np.float32), 0.8,
        (min(block[0], cin), block[1]))
    return wt, weight_align(wt, policy=ExecutionPolicy(block_shape=block))


def test_f32_operands_are_never_rounded():
    """An f32 activation and f32 blocks are handed over as they are (no
    copy); a bf16 activation and bf16 blocks are widened to f32, exactly."""
    rng = np.random.default_rng(5)
    _, al = _aligned(rng, 64, 64, 3, (64, 64))
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, 64)).astype(
        np.float32))
    xk, blocks, bk = sconv_pipe.kernel_operands(x, al, "float32")
    assert xk.data_ptr() == x.data_ptr() and bk == 64
    assert blocks.data_ptr() == al.bsc.blocks.data_ptr()
    xb, alb = x.bfloat16(), al.to("cpu", torch.bfloat16)
    xk, blocks, _ = sconv_pipe.kernel_operands(xb, alb, "float32")
    assert xk.dtype == blocks.dtype == torch.float32
    assert torch.equal(xk, xb.float()) and torch.equal(xk.bfloat16(), xb)
    assert torch.equal(blocks, alb.bsc.blocks.float())
    # the bf16 multiply still rounds, as before
    xk16, _, _ = sconv_pipe.kernel_operands(x, al)
    assert xk16.dtype == torch.bfloat16


@pytest.mark.parametrize("cin,block", [(30, (128, 128)), (30, (6, 16)),
                                       (20, (12, 16)), (64, (64, 64))])
def test_f32_operands_compute_the_same_conv(cin, block):
    """x and the blocks as the f32 kernels copy them (channels and bk padded
    to multiples of 4, not 8) give the f32 conv of the unpadded operands:
    no bf16 rounding on the way."""
    rng = np.random.default_rng(4)
    wt, al = _aligned(rng, cin, 24, 3, block)
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, cin)).astype(
        np.float32))
    xk, blocks, bk = sconv_pipe.kernel_operands(x, al, "float32")
    bsc = al.bsc
    assert xk.dtype == blocks.dtype == torch.float32
    n_cin_b = al.cin_pad // bsc.block_shape[0]
    assert bk == bsc.block_shape[0] + -bsc.block_shape[0] % 4
    assert blocks.shape[2] == bk
    # re-blocked where bk is not a multiple of 4, else channels padded
    assert xk.shape[-1] == (n_cin_b * bk if bsc.block_shape[0] % 4
                            else cin + -cin % 4)
    wk = dataclasses.replace(
        bsc, blocks=blocks, shape=(9 * n_cin_b * bk, bsc.shape[1]),
        block_shape=(bk, bsc.block_shape[1])).to_dense()
    wk = wk.reshape(3, 3, n_cin_b * bk, al.cout)[:, :, :xk.shape[-1]]

    def conv(a, w):
        return F.conv2d(a.double().permute(0, 3, 1, 2),
                        w.double().permute(3, 2, 0, 1), padding=1)

    ref = conv(x, torch.from_numpy(wt))
    torch.testing.assert_close(conv(xk, wk), ref, rtol=1e-6, atol=1e-6)
    # operands rounded to bf16 would miss by far more
    assert (conv(x.bfloat16(), torch.from_numpy(wt).bfloat16())
            - ref).abs().max() > 1e-3


@pytest.mark.parametrize("m,k,n,block", [(40, 203, 72, (64, 64)),
                                         (24, 100, 48, (6, 16)),
                                         (16, 512, 128, (128, 128))])
def test_f32_spmm_operands_compute_the_same_product(m, k, n, block):
    """A and the blocks as ``bsc_spmm``'s f32 kernel copies them: K and bk
    padded to multiples of 4, never rounded; the padded product is A @ W."""
    rng = np.random.default_rng(6)
    w = pruning.prune_blocks(rng.standard_normal((k, n)).astype(np.float32),
                             0.5, block)
    bsc = dense_to_bsc(w, block)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    ak, blocks, bk = bsc_spmm.kernel_operands(a, bsc, "float32")
    assert ak.dtype == blocks.dtype == torch.float32
    assert ak.shape[1] % 4 == 0 and bk % 4 == 0 and bk < block[0] + 4
    kp = bsc.n_brows * bk
    wk = dataclasses.replace(bsc, blocks=blocks, shape=(kp, bsc.shape[1]),
                             block_shape=(bk, block[1])).to_dense().double()
    ak_full = F.pad(ak, (0, kp - ak.shape[1])) if bk == block[0] else ak
    ref = a.double() @ torch.from_numpy(w).double()
    got = ak_full.double() @ wk
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    assert bsc_spmm.launch_plan(m, bsc, "float32").chunk == 32


def _old_key(aligned, x_shape, stride, padding, dilation, dtype):
    """The key as ``cache_key`` wrote it before the multiply type joined it
    (the JAX key's layout, the device first)."""
    return repr((autotune._device_label(aligned.bsc.blocks.device),
                 tuple(x_shape), str(dtype), tuple(aligned.kernel_shape),
                 tuple(stride), tuple(padding), tuple(dilation),
                 aligned.cin_pad, aligned.cout, aligned.groups,
                 tuple(aligned.bsc.block_shape),
                 autotune._pattern_sig(aligned)))


def test_autotune_key_keeps_bf16_keys_and_separates_f32():
    rng = np.random.default_rng(7)
    _, al = _aligned(rng, 32, 64, 3, (16, 16))
    shape, geo = (2, 8, 8, 32), ((1, 1), (1, 1), (1, 1))
    for dtype in (torch.bfloat16, torch.float32):
        old = _old_key(al, shape, *geo, dtype)
        bf16 = autotune.cache_key(al, shape, *geo, dtype, "bfloat16")
        f32 = autotune.cache_key(al, shape, *geo, dtype, "float32")
        assert bf16 == old  # byte for byte
        assert f32 != bf16 and ast.literal_eval(f32) == \
            ast.literal_eval(old) + ("float32",)
        # "auto" resolves on the weight's device: f32 on the CPU
        assert autotune.cache_key(al, shape, *geo, dtype) == f32


def test_f32_run_is_not_served_a_bf16_pick(tmp_path, monkeypatch):
    """A table holding a bf16-multiply pick for a key: a run that multiplies
    in f32 measures its own, a bf16 run is served the pick."""
    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    autotune.clear()
    try:
        rng = np.random.default_rng(8)
        _, al = _aligned(rng, 32, 32, 3, (16, 16))
        shape, geo = (1, 6, 6, 32), ((1, 1), (1, 1), (1, 1))
        autotune._CACHE[autotune.cache_key(al, shape, *geo, torch.float32,
                                           "bfloat16")] = "fused"
        measured = []
        monkeypatch.setattr(autotune, "measure",
                            lambda *a, **k: measured.append(1) or {
                                "unroll": 1.0, "dense": 2.0})
        pol16 = ExecutionPolicy(block_shape=(16, 16), mxu_dtype="bfloat16")
        pol32 = ExecutionPolicy(block_shape=(16, 16), mxu_dtype="float32")
        assert conv_ops.measured_arm(al, pol16, shape, *geo) == "fused"
        assert measured == []
        assert conv_ops.measured_arm(al, pol32, shape, *geo) == "unroll"
        assert measured == [1]
    finally:
        autotune.clear()


@pytest.fixture(scope="module")
def f32_slice():
    """The narrow VGG-16 of test_torch_vgg.py, both sides multiplying in
    f32: the JAX Pallas kernels in interpret mode, the port's entries with
    ``mxu_dtype="float32"`` (their plain versions, on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvgg, "_CFG", tvgg.NARROW)
        mp.setattr(vgg, "_CFG", tvgg.NARROW)
        jpol = JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=tvgg.BLOCK,
                       use_pallas=True, interpret=True, mxu_dtype="float32",
                       use_xla_sparse=False, spmm_tile_m=64)
        jnet = JNet(jvgg.vgg16(num_classes=10), policy=jpol, phase="test")
        jparams = jnet.init(jax.random.PRNGKey(1), tvgg.SHAPES)
        np_params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                     for k, v in jparams.items()}
        pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                              block_shape=tvgg.BLOCK, use_xla_sparse=False,
                              mxu_dtype="float32")
        net = Net(vgg.vgg16(num_classes=10), policy=pol)
        params, _ = params_from_jax(np_params)
        jpruned = tvgg._prune(jnet.specs, np_params,
                              jpruning.prune_conv_weight,
                              jpruning.prune_blocks, jnp.asarray)
        pruned = tvgg._prune(net.specs, params, pruning.prune_conv_weight,
                             pruning.prune_blocks, torch.from_numpy)
        jfnet, jfparams = jfuse(jnet, jpruned)
        fnet, fparams = fuse_inference(net, pruned)
        jaligned = jfnet.weight_align(jfparams)
        aligned = fnet.weight_align(fparams)
        mp.setattr(jsconv_fused, "VMEM_BUDGET", tvgg.VMEM_BUDGET)
        mp.setattr(sconv_fused, "VMEM_BUDGET", tvgg.VMEM_BUDGET)
        mp.setattr(jsconv_pallas, "SLAB_BUDGET", tvgg.SLAB_BUDGET)
        mp.setattr(sconv_gc, "SLAB_BUDGET", tvgg.SLAB_BUDGET)
        x = np.random.default_rng(2).standard_normal(
            tvgg.SHAPES["data"]).astype(np.float32)
        jblobs = jfnet.apply(jaligned, {"data": jnp.asarray(x)},
                             return_blobs=True)
        for mod in (sconv_fused, sconv_gc, bsc_spmm):
            mod.reset_counts()
        blobs = fnet.apply(aligned, {"data": torch.from_numpy(x)},
                           return_blobs=True)
        calls = {"fused": sconv_fused.calls, "gc": sconv_gc.calls,
                 "spmm": bsc_spmm.calls}
        routes = fnet.routes(aligned, tvgg.SHAPES)
    return dict(jblobs=jblobs, blobs=blobs, calls=calls, routes=routes)


def test_f32_slice_reaches_the_three_kernels(f32_slice):
    assert f32_slice["routes"] == tvgg.EXPECT_ROUTES
    # six fused, three gc; the SpMM takes the three lowered convs and fc6-8
    assert f32_slice["calls"] == {"fused": 6, "gc": 3, "spmm": 6}


def test_f32_slice_matches_jax_in_f32(f32_slice):
    """Every blob within 1e-5 relative L2 of the JAX package's f32
    multiplies (f32 on both sides, sums in another order)."""
    blobs, jblobs = f32_slice["blobs"], f32_slice["jblobs"]
    assert set(blobs) == set(jblobs)
    for name, out in blobs.items():
        ref = np.asarray(jblobs[name], np.float64)
        got = out.double().numpy()
        assert got.shape == ref.shape and np.isfinite(got).all(), name
        rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= NET_REL_L2, (name, rel)
    assert float(blobs["fc8"].abs().max()) > 1e-2  # the signal survived
