"""The port's parallel/ (mesh, halo, tp, dp, launch, dryrun) and
tools/scaling.py against the JAX package's, on the same numpy inputs made
from a seed.

The JAX side runs in this process on the conftest's virtual 8-device CPU
mesh, with Pallas in interpret mode where its own tests use it
(tests/test_parallel.py). The port side runs in gloo process groups:
``ranks``, a module-scoped fixture, starts one ``launch.Ranks`` pool per
world size (a ``file://`` store under tmp_path, no TCP port) and every case
runs its job on each rank. A rank's job takes the whole inputs, cuts its
own shard, runs the port's function on it and returns what it holds after
the function's own all-gather (or its whole rows, gathered here). Every
rank's result is checked. The jobs are module-level functions, which the
spawned ranks import by name.

Tolerances: the halo, TP and GSPMD forwards to rtol 1e-4, atol 1e-5, as the
JAX package's own tests hold them to the dense oracle; the DP step to 1e-5
relative L2 per param (and BatchNorm buffer) and loss, except a conv
bias that feeds a BatchNorm, whose exact gradient is zero, to 1e-8
absolute (the update of such a bias is f32 rounding noise of about 1e-9
on both sides); the DP forward
makes zero collective calls, counted by patching ``torch.distributed`` on
each rank.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from caffe_escoin_tpu.engine import solvers as jsolvers  # noqa: E402
from caffe_escoin_tpu.engine.context import (  # noqa: E402
    ExecutionPolicy as JPolicy)
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.parallel import dp as jdp  # noqa: E402
from caffe_escoin_tpu.parallel import halo as jhalo  # noqa: E402
from caffe_escoin_tpu.parallel import mesh as jmesh  # noqa: E402
from caffe_escoin_tpu.parallel import tp as jtp  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import (  # noqa: E402
    weight_align as jweight_align)
from caffe_escoin_tpu.utils.pruning import prune_conv_weight  # noqa: E402

from caffe_escoin_tpu_torch.parallel.launch import Ranks  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
DP_REL = 1e-5
BN_BIAS_ABS = 1e-8

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    """A pool of ``request.param`` gloo ranks, kept for the module's cases
    of that world (pytest groups them)."""
    world = request.param
    pool = Ranks(world, platform="cpu", run_timeout_s=120.0,
                 store_dir=str(tmp_path_factory.mktemp(f"ranks{world}")))
    yield pool
    pool.close()


def _worlds(*worlds):
    return pytest.mark.parametrize("ranks", worlds, indirect=True,
                                   ids=[f"world{w}" for w in worlds])


def _jmesh(data, model):
    return jmesh.make_mesh(data=data, model=model,
                           devices=jax.devices()[:data * model])


# ---------------------------------------------------------------------
# the ranks' jobs (module level: the spawned ranks import them by name)
# ---------------------------------------------------------------------

_MESHES = {}


def _mesh(data, model):
    """This rank's (data, model) mesh, made once per shape."""
    from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib

    if (data, model) not in _MESHES:
        _MESHES[data, model] = mesh_lib.make_mesh(data, model)
    return _MESHES[data, model]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    return tree


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _job_mesh():
    import torch.distributed as dist

    from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib

    m = mesh_lib.make_mesh(data=4, model=2)
    m2 = mesh_lib.make_mesh(model=2)
    return (dict(zip(m.mesh_dim_names, m.shape)),
            dict(zip(m2.mesh_dim_names, m2.shape)),
            dist.get_rank(), mesh_lib.axis_index(m, "data"),
            mesh_lib.axis_index(m, "model"))


def _job_psum():
    import torch.distributed as dist

    local = torch.full((8,), dist.get_rank() + 1.0)
    dist.all_reduce(local)
    return dist.get_world_size(), float(local.sum())


def _job_exit_on_rank1():
    """Rank 1's process dies without a result; rank 0 returns."""
    import os

    import torch.distributed as dist

    if dist.get_rank() == 1:
        os._exit(3)
    return 0


def _job_init_again():
    import torch.distributed as dist

    from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib

    before = dist.get_world_size()
    mesh_lib.multihost_init(platform="cpu")  # a group exists: no-op
    return before, dist.get_world_size()


def _job_halo_dense(x, w, b, mesh_shape):
    from caffe_escoin_tpu_torch.parallel import halo

    mesh = _mesh(*mesh_shape)
    xl = halo.shard_rows(torch.from_numpy(x), mesh)
    out = halo.spatial_conv2d(xl, torch.from_numpy(w), torch.from_numpy(b),
                              mesh=mesh, kernel=w.shape[:2],
                              padding=((w.shape[0] - 1) // 2,) * 2)
    return halo.gather_rows(out, mesh).numpy()


def _job_halo_sparse(x, w, b, block, mesh_shape, engine, padding, stride,
                     groups):
    """The gathered output, or the ValueError the port raised."""
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
    from caffe_escoin_tpu_torch.parallel import halo
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align

    mesh = _mesh(*mesh_shape)
    pol = ExecutionPolicy(block_shape=block)
    al = weight_align(w, b, groups=groups, policy=pol)
    xl = halo.shard_rows(torch.from_numpy(x), mesh)
    try:
        out = halo.spatial_sconv2d(xl, al, mesh=mesh, padding=padding,
                                   policy=pol, stride=stride, engine=engine)
    except ValueError as e:
        return ("ValueError", str(e))
    return halo.gather_rows(out, mesh).numpy()


def _job_halo_stack(x, ws, block, mesh_shape, kind):
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
    from caffe_escoin_tpu_torch.parallel import halo
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align

    mesh = _mesh(*mesh_shape)
    pol = ExecutionPolicy(block_shape=block)
    als = [weight_align(w, None, policy=pol) for w in ws]
    fn = (halo.spatial_sconv_tower if kind == "tower"
          else halo.spatial_sconv_chain)
    try:
        out = fn(halo.shard_rows(torch.from_numpy(x), mesh), als, mesh=mesh,
                 policy=pol, relu=True)
    except ValueError as e:
        return ("ValueError", str(e))
    return halo.gather_rows(out, mesh).numpy()


def _job_tp(x, w, b, block, mesh_shape):
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
    from caffe_escoin_tpu_torch.parallel import tp
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align

    mesh = _mesh(*mesh_shape)
    pol = ExecutionPolicy(block_shape=block)
    al = weight_align(w, b, policy=pol)
    return tp.tp_conv_lowered(torch.from_numpy(x), al, mesh=mesh,
                              padding=(1, 1), policy=pol).numpy()


def _job_gspmd(model, params, x, mesh_shape):
    from torch.distributed.tensor import Shard

    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net
    from caffe_escoin_tpu_torch.parallel import tp

    mesh = _mesh(*mesh_shape)
    net = Net(ZOO[model][0]())
    p = _t(params)
    sh = tp.param_shardings(p, mesh)
    local = tp.local_params(p, sh, mesh)
    out = tp.forward_sharded(net, local, {"data": torch.from_numpy(x)},
                             mesh)["prob"]
    model = mesh.mesh_dim_names.index("model")
    dims = {n: {k: (s[model].dim if isinstance(s[model], Shard) else None)
                for k, s in d.items()} for n, d in sh.items()}
    return out.numpy(), dims


def _job_placements(x, mesh_shape):
    """This rank's blocks of x under batch_sharding and replicated."""
    from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib

    mesh = _mesh(*mesh_shape)
    t = torch.from_numpy(x)
    return tuple(mesh_lib.local_shard(t, pl, mesh).numpy()
                 for pl in (mesh_lib.batch_sharding(mesh),
                            mesh_lib.replicated(mesh)))


def _job_dp_step(model, params, net_state, batch, mesh_shape, cfg_kw, lr,
                 it):
    from caffe_escoin_tpu_torch.engine import solvers
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net
    from caffe_escoin_tpu_torch.parallel import dp

    mesh = _mesh(*mesh_shape)
    net = Net(ZOO[model][0](include_loss=True), phase="train", device="cpu")
    cfg = solvers.SolverConfig(**cfg_kw)
    p = dp.replicate_params(mesh, _t(params))
    state = solvers.init_state(cfg, p)
    b = dp.shard_batch(mesh, _t(batch))
    step = dp.make_dp_train_step(net, cfg, mesh)
    p2, _, ns2, loss = step(p, state, _t(net_state), b, lr, it, None)
    return _np(p2), _np(ns2), float(loss)


def _job_dp_eval(x, w, params, images, mesh_shape):
    """(the conv's and lenet's batch-sharded forwards, gathered here, and
    the collective calls they made)."""
    import torch.distributed as dist

    from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                       ExecutionPolicy)
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net
    from caffe_escoin_tpu_torch.ops.conv import conv2d_sconv
    from caffe_escoin_tpu_torch.parallel import dp
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align

    mesh = _mesh(*mesh_shape)
    pol = ExecutionPolicy(block_shape=(8, 8))
    al = weight_align(w, None, policy=pol)
    xl = dp.shard_batch(mesh, {"data": torch.from_numpy(x)})["data"]
    net = Net(ZOO["lenet"][0](), policy=ExecutionPolicy(
        conv_mode=ConvMode.SCONV_PAR, block_shape=(8, 8)))
    aligned = net.weight_align(_t(params))
    batch = dp.shard_batch(mesh, {"data": torch.from_numpy(images)})
    step = dp.make_dp_eval_step(net, mesh)
    names = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
             "broadcast", "send", "recv", "isend", "irecv",
             "batch_isend_irecv", "barrier")
    calls = []
    saved = {n: getattr(dist, n) for n in names}
    try:
        for n in names:
            setattr(dist, n, lambda *a, _n=n, **k: calls.append(_n))
        with torch.inference_mode():
            conv = conv2d_sconv(xl, al, stride=(1, 1), padding=(1, 1),
                                dilation=(1, 1), relu=False, policy=pol,
                                batch_parallel=True)
        probs = step(aligned, batch)["prob"]
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
    return conv.numpy(), probs.numpy(), calls


# ---------------------------------------------------------------------
# the mesh, the rendezvous
# ---------------------------------------------------------------------

@requires_8
@_worlds(8)
def test_mesh_construction(ranks):
    jm = jmesh.make_mesh(data=4, model=2)
    jm2 = jmesh.make_mesh(model=2)
    coords = {d.id: tuple(int(i) for i in np.argwhere(jm.devices == d)[0])
              for d in jm.devices.flat}
    for shape, shape2, rank, di, mi in ranks.run(_job_mesh):
        assert shape == dict(jm.shape)
        assert shape2 == dict(jm2.shape)
        assert (di, mi) == coords[jax.devices()[rank].id]


def test_multihost_init_raises_on_failed_rendezvous(tmp_path):
    """The JAX function swallows a failed rendezvous; the port raises, and
    leaves no group behind."""
    import torch.distributed as dist

    from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib

    with pytest.raises(RuntimeError):
        mesh_lib.multihost_init(f"file://{tmp_path}/store", 2, 0,
                                platform="cpu", timeout_s=2)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs an init_method"):
        mesh_lib.multihost_init(world_size=2, rank=0, platform="cpu")


def test_ranks_fail_a_run_when_a_rank_dies(tmp_path):
    """A rank's process that dies mid-run fails the run at once with the
    rank named, well inside the run timeout, and closes the pool."""
    import time

    from caffe_escoin_tpu_torch.parallel.launch import RankError

    pool = Ranks(2, platform="cpu", run_timeout_s=120.0,
                 store_dir=str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(RankError, match=r"ranks \[1\] of 2 exited"):
        pool.run(_job_exit_on_rank1)
    assert time.monotonic() - t0 < 30.0
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(_job_psum)


# ---------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------

DP_CASES = {  # model -> (input shape, JAX solver config)
    "lenet": ((28, 28, 1), dict(solver_type="sgd", base_lr=0.1,
                                momentum=0.9)),
    # 31x31: no average-pool window crosses the edge, where the port's
    # Caffe divisor differs from the JAX pool (tests/test_torch_solver_loop)
    "cifar10_bn": ((31, 31, 3), dict(solver_type="sgd", base_lr=0.01,
                                     momentum=0.9, weight_decay=1e-4)),
}


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64)
                                - np.asarray(want, np.float64))
                 / max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


def _dp_case(ranks, model, data):
    hw, cfg_kw = DP_CASES[model]
    batch_n = 16
    net = JNet(JZOO[model][0](include_loss=True), phase="train")
    params = net.init(jax.random.PRNGKey(0), {"data": (batch_n,) + hw,
                                              "label": (batch_n,)})
    params = jax.tree_util.tree_map(np.asarray, params)
    net_state = jax.tree_util.tree_map(np.asarray, net.state0)
    rng = np.random.default_rng(0)
    batch = {"data": rng.standard_normal((batch_n,) + hw).astype(np.float32),
             "label": rng.integers(0, 10, batch_n).astype(np.int32)}
    cfg = jsolvers.SolverConfig(**cfg_kw)
    mesh = _jmesh(data, 1)
    step = jdp.make_dp_train_step(net, cfg, mesh)
    jp, _, jns, jloss = step(
        jdp.replicate_params(mesh, params),
        jdp.replicate_params(mesh, jsolvers.init_state(cfg, params)),
        jdp.replicate_params(mesh, net_state),
        jdp.shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
        jnp.float32(cfg.base_lr), jnp.int32(1), jax.random.PRNGKey(1))
    results = ranks.run(_job_dp_step, model, params, net_state, batch,
                        (data, ranks.world // data), cfg_kw, cfg.base_lr, 1)
    # a conv bias whose output reaches a BatchNorm through max pools only
    # has a zero exact gradient: both steps move it by rounding noise (~1e-9
    # here), held to an absolute bound
    by_bottom = {t.bottoms[0]: t for t in net.specs if t.bottoms}
    before_bn = set()
    for spec in net.specs:
        nxt = by_bottom.get(spec.tops[0])
        while nxt is not None and nxt.type == "Pooling":
            nxt = by_bottom.get(nxt.tops[0])
        if nxt is not None and nxt.type == "BatchNorm":
            before_bn.add(spec.name)
    for p2, ns2, loss in results:
        assert _rel(loss, jloss) <= DP_REL
        for tree_got, tree_want in ((p2, jp), (ns2, jns)):
            for name, blobs in tree_want.items():
                for k, v in blobs.items():
                    if tree_got is p2 and name in before_bn and k == "b":
                        np.testing.assert_allclose(tree_got[name][k], v,
                                                   rtol=0, atol=BN_BIAS_ABS)
                    else:
                        assert _rel(tree_got[name][k], v) <= DP_REL, (name,
                                                                     k)


@requires_8
@_worlds(8)
def test_dp_train_step_matches_jax_world8(ranks):
    """The JAX test's configuration: lenet over 8 data ranks."""
    _dp_case(ranks, "lenet", 8)


@requires_8
@_worlds(8)
def test_dp_inference_forward_is_collective_free(ranks):
    """The batch-sharded sparse conv and net forward make no collective
    call, and give the JAX forward's rows."""
    rng = np.random.default_rng(0)
    w = prune_conv_weight(rng.standard_normal((3, 3, 16, 32)).astype(
        np.float32), 0.8, (8, 8))
    x = rng.standard_normal((8, 8, 8, 16)).astype(np.float32)
    jpol = JPolicy(block_shape=(8, 8))
    from caffe_escoin_tpu.engine.context import ConvMode as JMode
    from caffe_escoin_tpu.ops.conv import conv2d_sconv as jconv

    want = np.asarray(jconv(jnp.asarray(x), jweight_align(w, None,
                                                          policy=jpol),
                            stride=(1, 1), padding=(1, 1), dilation=(1, 1),
                            relu=False, policy=jpol, batch_parallel=True))
    net = JNet(JZOO["lenet"][0](), policy=JPolicy(
        conv_mode=JMode.SCONV_PAR, block_shape=(8, 8)))
    params = net.init(jax.random.PRNGKey(0), {"data": (8, 28, 28, 1)})
    params = jax.tree_util.tree_map(np.asarray, params)
    images = (np.zeros((8, 28, 28, 1), np.float32)
              + np.arange(8, dtype=np.float32)[:, None, None, None] / 8)
    want_p = np.asarray(net.apply(net.weight_align(params),
                                  {"data": jnp.asarray(images)})["prob"])
    for r, (conv, probs, calls) in enumerate(
            ranks.run(_job_dp_eval, x, w, params, images, (8, 1))):
        assert calls == []
        np.testing.assert_allclose(conv, want[r:r + 1], **TOL)
        np.testing.assert_allclose(probs, want_p[r:r + 1], **TOL)


# ---------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------

def _check_all(results, want, **tol):
    for got in results:
        assert not isinstance(got, tuple), got
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **(tol or TOL))


@requires_8
@pytest.mark.parametrize("model_axis", [2, 4])
@_worlds(8)
def test_halo_spatial_conv_matches_jax(ranks, model_axis):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 12, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jhalo.spatial_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        mesh=_jmesh(8 // model_axis, model_axis), kernel=(3, 3),
        padding=(1, 1)))
    _check_all(ranks.run(_job_halo_dense, x, w, b,
                         (8 // model_axis, model_axis)), want)


def _sparse_case(seed=0, cin=16, cout=32, k=3, sparsity=0.85,
                 block=(16, 16), groups=1, h=16):
    rng = np.random.default_rng(seed)
    w = prune_conv_weight(rng.standard_normal(
        (k, k, cin // groups, cout)).astype(np.float32), sparsity, block)
    b = rng.standard_normal(cout).astype(np.float32)
    x = rng.standard_normal((2, h, 8, cin)).astype(np.float32)
    return x, w, b


def _jhalo_sparse(x, w, b, mesh, policy, **kw):
    al = jweight_align(w, b, groups=kw.pop("groups", 1), policy=policy)
    return np.asarray(jhalo.spatial_sconv2d(jnp.asarray(x), al, mesh=mesh,
                                            policy=policy, **kw))


@pytest.mark.parametrize("engine", ["pallas", "auto"])
@_worlds(8, 1)
def test_halo_spatial_sparse_conv_matches_jax(ranks, engine):
    """Halo exchange + the direct sparse conv over 4 rows-shards (world
    8, the JAX test's mesh) and over one (world 1): "pallas" is the Pallas
    kernel (interpret) against the port's sconv_gc plain version, "auto"
    the dispatchers."""
    x, w, b = _sparse_case()
    model = 4 if ranks.world == 8 else 1
    pol = JPolicy(block_shape=(16, 16), use_pallas=True, interpret=True,
                  spmm_tile_m=64)
    want = _jhalo_sparse(x, w, b, _jmesh(ranks.world // model, model), pol,
                         padding=(1, 1), engine=engine)
    _check_all(ranks.run(_job_halo_sparse, x, w, b, (16, 16),
                         (ranks.world // model, model), engine, (1, 1),
                         (1, 1), 1), want)


@requires_8
@_worlds(8)
def test_halo_pallas_engine_refuses_what_sconv_gc_does_not_take(ranks):
    """A stride-2 conv and a weight in blocks 12 wide (sconv_gc's epilogue
    tiles multiples of 8) raise; nothing re-routes."""
    x, w, b = _sparse_case()
    (err,) = set(r[0] for r in ranks.run(
        _job_halo_sparse, x, w, b, (16, 16), (2, 4), "pallas", (1, 1),
        (2, 2), 1))
    assert err == "ValueError"
    x, w, b = _sparse_case(block=(16, 12))
    results = ranks.run(_job_halo_sparse, x, w, b, (16, 12), (2, 4),
                        "pallas", (1, 1), (1, 1), 1)
    for r in results:
        assert r[0] == "ValueError" and "sconv_gc" in r[1]


@requires_8
@pytest.mark.parametrize("shards", [2, 4, 8])
@_worlds(8)
def test_halo_xbsp_engine_matches_jax(ranks, shards):
    x, w, b = _sparse_case(sparsity=0.8, block=(1, 8))
    pol = JPolicy(block_shape=(8, 8))
    want = _jhalo_sparse(x, w, b, _jmesh(8 // shards, shards), pol,
                         padding=(1, 1), engine="auto")
    _check_all(ranks.run(_job_halo_sparse, x, w, b, (8, 8),
                         (8 // shards, shards), "auto", (1, 1), (1, 1), 1),
               want)


@requires_8
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("k,pad", [(3, 1), (1, 0)])
@_worlds(8)
def test_halo_stride2_at_partition_boundaries(ranks, shards, k, pad):
    x, w, b = _sparse_case(k=k, sparsity=0.8, block=(1, 8))
    pol = JPolicy(block_shape=(8, 8))
    want = _jhalo_sparse(x, w, b, _jmesh(8 // shards, shards), pol,
                         padding=(pad, pad), stride=(2, 2))
    _check_all(ranks.run(_job_halo_sparse, x, w, b, (8, 8),
                         (8 // shards, shards), "auto", (pad, pad), (2, 2),
                         1), want)


@requires_8
@pytest.mark.parametrize("shards", [2, 4])
@_worlds(8)
def test_halo_grouped_conv_at_partition_boundaries(ranks, shards):
    x, w, b = _sparse_case(cout=32, sparsity=0.75, block=(1, 8), groups=2)
    pol = JPolicy(block_shape=(8, 8))
    want = _jhalo_sparse(x, w, b, _jmesh(8 // shards, shards), pol,
                         padding=(1, 1), groups=2)
    _check_all(ranks.run(_job_halo_sparse, x, w, b, (8, 8),
                         (8 // shards, shards), "auto", (1, 1), (1, 1), 2),
               want)


@requires_8
@_worlds(8)
def test_halo_stride_residual_shape_guard(ranks):
    """12 rows over 4 shards is 3 per rank, not divisible by stride 2."""
    rng = np.random.default_rng(0)
    w = prune_conv_weight(rng.standard_normal((3, 3, 8, 16)).astype(
        np.float32), 0.8, (1, 8))
    x = np.zeros((1, 12, 8, 8), np.float32)
    for r in ranks.run(_job_halo_sparse, x, w, None, (8, 8), (2, 4), "auto",
                       (1, 1), (2, 2), 1):
        assert r[0] == "ValueError" and "divisible" in r[1]


def _stack_weights(rng, ks=(3, 1, 3), couts=(16, 16, 32), k_big=None):
    ws, cin = [], 16
    for k, cout in zip(ks, couts):
        ws.append(prune_conv_weight(rng.standard_normal(
            (k, k, cin, cout)).astype(np.float32), 0.8, (16, 16)))
        cin = cout
    return ws


@requires_8
@pytest.mark.parametrize("kind", ["tower", "chain"])
@_worlds(8)
def test_halo_stack_matches_jax(ranks, kind):
    """spatial_sconv_tower (one exchange of the summed halo, the global
    edge rows re-zeroed after each layer) and spatial_sconv_chain (one
    exchange per layer) over a k3 -> 1x1 -> k3 chain on 4 shards."""
    rng = np.random.default_rng(0)
    ws = _stack_weights(rng)
    x = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    pol = JPolicy(block_shape=(16, 16), use_pallas=False)
    fn = (jhalo.spatial_sconv_tower if kind == "tower"
          else jhalo.spatial_sconv_chain)
    want = np.asarray(fn(jnp.asarray(x),
                         [jweight_align(w, None, policy=pol) for w in ws],
                         mesh=_jmesh(2, 4), policy=pol, relu=True))
    _check_all(ranks.run(_job_halo_stack, x, ws, (16, 16), (2, 4), kind),
               want, rtol=1e-4, atol=1e-4)


@requires_8
@_worlds(8)
def test_halo_deep_tower_rejects_oversized_halo(ranks):
    rng = np.random.default_rng(0)
    w = prune_conv_weight(rng.standard_normal((7, 7, 16, 16)).astype(
        np.float32), 0.8, (16, 16))
    x = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    pol = JPolicy(block_shape=(16, 16))
    with pytest.raises(ValueError, match="deep halo"):
        jhalo.spatial_sconv_tower(jnp.asarray(x),
                                  [jweight_align(w, None, policy=pol)] * 2,
                                  mesh=_jmesh(2, 4), policy=pol)
    for r in ranks.run(_job_halo_stack, x, [w, w], (16, 16), (2, 4),
                       "tower"):
        assert r[0] == "ValueError" and "deep halo" in r[1]


# ---------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------

@_worlds(8, 1)
def test_tp_lowered_sparse_conv_matches_jax(ranks):
    """The block columns over 4 model ranks (world 8, the JAX test's
    mesh) and whole on one (world 1)."""
    rng = np.random.default_rng(0)
    w = prune_conv_weight(rng.standard_normal((3, 3, 16, 64)).astype(
        np.float32), 0.8, (16, 8))
    b = rng.standard_normal(64).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    model = 4 if ranks.world == 8 else 1
    pol = JPolicy(block_shape=(16, 8), use_pallas=False)
    al = jweight_align(w, b, policy=pol)
    assert al.bsc.n_bcols % 4 == 0
    want = np.asarray(jtp.tp_conv_lowered(
        jnp.asarray(x), al, mesh=_jmesh(ranks.world // model, model),
        padding=(1, 1), policy=pol))
    _check_all(ranks.run(_job_tp, x, w, b, (16, 8),
                         (ranks.world // model, model)), want)


def test_tp_local_bsc_carries_its_own_host_pattern():
    """A rank's block columns keep their own nnz_blocks and host pattern
    (a dataclasses.replace would keep the whole matrix's), and
    shard_bsc_cout raises on an uneven split."""
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
    from caffe_escoin_tpu_torch.parallel import tp
    from caffe_escoin_tpu_torch.sparse.formats import dense_to_bsc
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align

    rng = np.random.default_rng(0)
    w = prune_conv_weight(rng.standard_normal((3, 3, 16, 64)).astype(
        np.float32), 0.8, (16, 8))
    bsc = weight_align(w, None,
                       policy=ExecutionPolicy(block_shape=(16, 8))).bsc
    parts = [tp.local_bsc(bsc, j, j + 2) for j in range(0, 8, 2)]
    assert sum(p.nnz_blocks for p in parts) == bsc.nnz_blocks
    for j, p in zip(range(0, 8, 2), parts):
        assert p.shape == (bsc.shape[0], 16)
        np.testing.assert_array_equal(p.bcol_nnz_np,
                                      bsc.bcol_nnz_np[j:j + 2])
        assert p.nnz_blocks == int(bsc.bcol_nnz_np[j:j + 2].sum())
        np.testing.assert_array_equal(
            p.to_dense().numpy(),
            bsc.to_dense().numpy()[:, j * 8:(j + 2) * 8])
    with pytest.raises(ValueError, match="not divisible"):
        tp.shard_bsc_cout(dense_to_bsc(np.ones((16, 24), np.float32),
                                       (16, 8)), 2)


@requires_8
@_worlds(8)
def test_gspmd_param_shardings(ranks):
    """The whole lenet forward with cout-sharded params over a (4, 2) mesh
    against the JAX jit with the same shardings; the placements follow the
    JAX specs leaf for leaf."""
    mesh = _jmesh(4, 2)
    net = JNet(JZOO["lenet"][0]())
    params = net.init(jax.random.PRNGKey(0), {"data": (4, 28, 28, 1)})
    shardings = jtp.param_shardings(net, params, mesh)
    p_sharded = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), params, shardings,
        is_leaf=lambda x: isinstance(x, NamedSharding))
    x = np.random.default_rng(0).standard_normal((4, 28, 28, 1)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: net.apply(p, x))(
        p_sharded, {"data": jnp.asarray(x)})["prob"])
    want_dims = {n: {k: (list(s.spec).index("model") if "model" in s.spec
                         else None) for k, s in d.items()}
                 for n, d in shardings.items()}
    params = jax.tree_util.tree_map(np.asarray, params)
    for out, dims in ranks.run(_job_gspmd, "lenet", params, x, (4, 2)):
        assert dims == want_dims
        np.testing.assert_allclose(out, want, **TOL)


@requires_8
@_worlds(8)
def test_mesh_placements_are_the_jax_specs(ranks):
    """batch_sharding and replicated over a (4, 2) mesh: each rank holds
    the block that the JAX NamedSharding puts on the device at its
    coordinate (rank r at data r // 2, model r % 2)."""
    mesh = _jmesh(4, 2)
    x = np.random.default_rng(3).standard_normal((8, 3, 5)).astype(
        np.float32)
    want = [jax.device_put(jnp.asarray(x), sh)
            for sh in (jmesh.batch_sharding(mesh), jmesh.replicated(mesh))]

    def block(arr, dev):
        (shard,) = [s for s in arr.addressable_shards if s.device == dev]
        return np.asarray(shard.data)

    for r, got in enumerate(ranks.run(_job_placements, x, (4, 2))):
        dev = mesh.devices[r // 2, r % 2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, block(w, dev))


# ---------------------------------------------------------------------
# worlds of two and four ranks (after the world-8 cases, so that each
# pool starts once)
# ---------------------------------------------------------------------

@_worlds(2)
def test_two_process_rendezvous_and_psum(ranks):
    """Counterpart of test_multiprocess.py: two processes joined by
    multihost_init sum across the process boundary."""
    assert ranks.run(_job_psum) == [(2, 8.0 * (1.0 + 2.0))] * 2


@_worlds(2)
def test_multihost_init_is_a_noop_in_a_group(ranks):
    assert ranks.run(_job_init_again) == [(2, 2)] * 2


@pytest.mark.parametrize("model", ["lenet", "cifar10_bn"])
@_worlds(2, 4)
def test_dp_train_step_matches_jax(ranks, model):
    """lenet, and cifar10_bn whose BatchNorm takes the global batch's
    statistics (an all-reduce per layer) as the JAX step does."""
    _dp_case(ranks, model, ranks.world)


# ---------------------------------------------------------------------
# the scaling harness and the dry run
# ---------------------------------------------------------------------

def test_scaling_harness_matches_jax_schema():
    """tools/scaling.measure at one and two ranks (gloo processes) gives
    the JAX row's keys, devices and batches, with the device named."""
    from caffe_escoin_tpu.tools.scaling import measure as jmeasure

    from caffe_escoin_tpu_torch.tools.scaling import measure

    for n in (1, 2):
        want = jmeasure("lenet", n, 4, 0.9, iters=1)
        got = measure("lenet", n, 4, 0.9, iters=1, platform="cpu")
        assert set(want) | {"device"} == set(got)
        for k in ("devices", "batch", "batch_per_dev"):
            assert got[k] == want[k]
        assert got["gnnz_per_s_per_dev"] > 0 and got["device"] == "cpu"


def test_scaling_cli_refuses_the_jax_record():
    from caffe_escoin_tpu_torch.tools import scaling

    assert scaling.main(["--out", str(scaling.JAX_RECORD), "--platform",
                         "cpu", "--devices", "1"]) == 2


def test_dryrun_multichip_two_ranks():
    """The dry run over two gloo ranks: the DP step, the batch-sharded
    sparse conv, the TP forward (held to the whole forward), halo and TP
    convs on a model axis of 2, and the fused, packed ResNet-50 forward
    with one image per rank."""
    from caffe_escoin_tpu_torch.parallel.dryrun import dryrun_multichip

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(2, platform="cpu")
    line = out.getvalue().strip()
    assert line.startswith("dryrun_multichip(2): OK (mesh {'data': 1, "
                           "'model': 2}"), line
    assert "resnet50 fused+packed[" in line


def test_scaling_cli_writes_rows_where_asked(tmp_path, capsys):
    """One rank in this process; the row printed and appended to --out."""
    import json

    from caffe_escoin_tpu_torch.tools import scaling

    out = tmp_path / "rows.jsonl"
    assert scaling.main(["--devices", "1", "--model", "lenet", "--platform",
                         "cpu", "--iters", "1", "--out",
                         str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 1
    assert (rows[0]["devices"], rows[0]["backend"], rows[0]["device"]) == (
        1, "cpu", "cpu")
    assert json.loads(capsys.readouterr().out) == rows
