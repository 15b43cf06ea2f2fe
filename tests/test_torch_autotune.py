"""The port's autotune (caffe_escoin_tpu_torch.engine.autotune) on the
deterministic cases of the JAX package's tests/test_autotune.py, and what
the port adds: its cache key and fingerprint, a TPU table never served, and
the router's measured picks (``ops.conv.measured_arm``,
``ops.linear.fc_arm``) with the measurement replaced, so nothing is timed.

``time_fn`` consults ``measured_arm`` as a whole forward does, but returns
a crafted cost model, so every decision of ``calibrate_graph`` is exact.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine import autotune as jautotune  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.engine import autotune  # noqa: E402
from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs  # noqa: E402
from caffe_escoin_tpu_torch.ops import conv as conv_ops  # noqa: E402
from caffe_escoin_tpu_torch.ops import linear as linear_ops  # noqa: E402
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils import benchmark  # noqa: E402
from caffe_escoin_tpu_torch.utils.benchmark import device_time  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight  # noqa: E402

POL = ExecutionPolicy(block_shape=(8, 8), autotune=True)


def _aligned(rng, cin, cout, k, sparsity=0.9):
    w = prune_conv_weight(
        rng.standard_normal((k, k, cin, cout)).astype(np.float32), sparsity,
        (8, 8))
    return w, weight_align(w, policy=POL)


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """An empty in-process table and a cache file of this test's own."""
    path = str(tmp_path / "arms.json")
    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE", path)
    autotune.clear()
    yield path
    autotune.clear()


@pytest.fixture
def two_keys(fresh):
    """Two aligned weights and shapes -> two cache keys, seeded with sparse
    winners (no measurement)."""
    rng = np.random.default_rng(0)
    _, a = _aligned(rng, 32, 32, 3)
    _, b = _aligned(rng, 32, 64, 1)
    shape = (2, 8, 8, 32)
    key_a = autotune.cache_key(a, shape, (1, 1), (1, 1), (1, 1),
                               torch.float32)
    key_b = autotune.cache_key(b, shape, (1, 1), (0, 0), (1, 1),
                               torch.float32)
    assert key_a != key_b
    autotune._CACHE[key_a] = "gathered"
    autotune._CACHE[key_b] = "unroll"

    def consult():
        """What a whole forward does: ask measured_arm per conv site
        (key_a twice: multiplicity)."""
        a1 = conv_ops.measured_arm(a, POL, shape, (1, 1), (1, 1), (1, 1))
        conv_ops.measured_arm(a, POL, shape, (1, 1), (1, 1), (1, 1))
        a2 = conv_ops.measured_arm(b, POL, shape, (1, 1), (0, 0), (1, 1))
        return a1, a2

    yield key_a, key_b, consult, fresh


def test_record_keys_collects_hits_with_multiplicity(two_keys):
    key_a, key_b, consult, _ = two_keys
    with autotune.record_keys() as rec:
        consult()
    assert [k for k, _ in rec] == [key_a, key_a, key_b]
    assert dict(rec) == {key_a: "gathered", key_b: "unroll"}


def test_log_hits_prints_each_cached_pick_outside_recording(
        two_keys, monkeypatch, capsys):
    """CESCOIN_AUTOTUNE_LOG_HITS, as in the JAX module: a pick served from
    the cache is printed, except inside record_keys (calibration)."""
    key_a, key_b, consult, _ = two_keys
    consult()
    assert "[autotune]" not in capsys.readouterr().out
    monkeypatch.setenv("CESCOIN_AUTOTUNE_LOG_HITS", "1")
    with autotune.record_keys():
        consult()
    assert "[autotune]" not in capsys.readouterr().out
    consult()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    assert "cached arm 'gathered'" in out[0] and "no re-measurement" in out[0]
    assert "cached arm 'unroll'" in out[2]


def test_calibrate_flips_losing_key_to_dense_and_persists(two_keys):
    key_a, key_b, consult, path = two_keys

    def time_fn():
        a1, a2 = consult()
        # key_a's sparse arm loses composed, key_b's wins
        return 1.0 + (0.5 if a1 != "dense" else 0.0) - (
            0.3 if a2 != "dense" else 0.0)

    rep = autotune.calibrate_graph(time_fn, log=lambda m: None)
    assert rep["t_isolated"] == pytest.approx(1.2)
    assert rep["t_dense"] == pytest.approx(1.0)
    assert rep["t_final"] == pytest.approx(0.7)
    assert rep["flips"] == 1
    assert rep["arms"] == {key_a: "dense", key_b: "unroll"}
    assert autotune._CACHE[key_a] == "dense"
    assert autotune._CACHE[key_b] == "unroll"
    with open(path) as fh:
        assert json.load(fh)[key_a] == "dense"
    assert autotune._OVERRIDES == {}
    assert consult() == ("dense", "unroll")


def test_calibrate_keeps_assignment_that_already_wins(two_keys):
    key_a, key_b, consult, _ = two_keys

    def time_fn():
        return 1.0 - 0.2 * sum(arm != "dense" for arm in consult())

    rep = autotune.calibrate_graph(time_fn, log=lambda m: None)
    assert rep["t_final"] == pytest.approx(0.6)
    assert rep["t_dense"] == pytest.approx(1.0)
    assert autotune._CACHE[key_a] == "gathered"
    assert autotune._CACHE[key_b] == "unroll"


def test_calibrate_no_sparse_keys_is_noop(fresh):
    rep = autotune.calibrate_graph(lambda: 1.0)
    assert rep["sparse_keys"] == 0 and rep["t_final"] == 1.0


def test_calibrate_polish_flips_to_better_alternative(two_keys):
    key_a, key_b, consult, _ = two_keys

    def time_fn():
        a1, a2 = consult()
        t = 1.0
        if a1 != "dense":
            t -= 0.1
        if a1 == "gathered_cols":
            t -= 0.2  # an alternative beats key_a's pick composed
        if a2 != "dense":
            t -= 0.1
        return t

    rep = autotune.calibrate_graph(time_fn, polish=8, log=lambda m: None)
    assert rep["t_final"] == pytest.approx(0.6)
    assert rep["polish_trials"] >= 1
    assert rep["arms"][key_a] == "gathered_cols"
    assert autotune._CACHE[key_a] == "gathered_cols"
    assert consult()[0] == "gathered_cols"


def test_calibrate_holds_each_trial_against_a_fresh_reading(two_keys):
    """The first whole-net reading after measurement reads high (eager
    times drift). Each trial is timed between fresh readings of the
    assignment it would replace, so a slower arm does not win against that
    stale reading: the isolated assignment stands through polish."""
    key_a, key_b, consult, _ = two_keys
    calls = []

    def time_fn():
        calls.append(1)
        t = 1.0 - 0.2 * sum(arm != "dense" for arm in consult())
        return t + (0.3 if len(calls) == 1 else 0.0)

    rep = autotune.calibrate_graph(time_fn, polish=8, log=lambda m: None)
    assert rep["t_first"] == pytest.approx(0.9)
    assert rep["t_isolated"] == pytest.approx(0.6)
    assert rep["t_final"] == pytest.approx(0.6)
    assert rep["polish_trials"] == 6
    assert rep["arms"] == {key_a: "gathered", key_b: "unroll"}
    assert autotune._OVERRIDES == {}


def test_calibrate_propagates_a_forward_that_raises(two_keys):
    """A polish trial whose forward raises fails the calibration: it is
    not counted as a trial without gain."""
    key_a, key_b, consult, _ = two_keys

    def time_fn():
        if "gathered_cols" in consult():
            raise RuntimeError("arm failed")
        return 1.0 - 0.2 * sum(arm != "dense" for arm in consult())

    with pytest.raises(RuntimeError, match="arm failed"):
        autotune.calibrate_graph(time_fn, polish=8, log=lambda m: None)
    assert autotune._OVERRIDES == {}


def test_net_scope_serves_a_demotion_only_inside_its_net(two_keys):
    """With ``net_tag``, a key calibration changed is stored per net and
    served only inside ``net_scope`` of that net; the global table keeps
    the isolated pick for other nets."""
    key_a, key_b, consult, path = two_keys

    def time_fn():
        a1, a2 = consult()
        return 1.0 + (0.5 if a1 != "dense" else 0.0) - (
            0.3 if a2 != "dense" else 0.0)

    with autotune.net_scope("resnet50"):
        rep = autotune.calibrate_graph(time_fn, net_tag="resnet50")
    assert rep["arms"] == {key_a: "dense", key_b: "unroll"}
    assert autotune._CACHE[key_a] == "gathered"
    assert autotune._CACHE["net=resnet50|" + key_a] == "dense"
    assert "net=resnet50|" + key_b not in autotune._CACHE
    assert consult() == ("gathered", "unroll")
    with autotune.net_scope("resnet50"):
        assert consult() == ("dense", "unroll")
    with autotune.net_scope("vgg16"):
        assert consult() == ("gathered", "unroll")
    with open(path) as fh:
        assert json.load(fh)["net=resnet50|" + key_a] == "dense"


def test_cache_file_invalidated_on_kernel_change(fresh):
    """The file records the port's kernel fingerprint and is ignored whole
    when it does not match, or has none."""
    autotune._CACHE["k1"] = "gathered"
    autotune._save_file(fresh)
    autotune.clear()
    autotune._load_file(fresh)
    assert autotune._CACHE.get("k1") == "gathered"

    with open(fresh) as fh:
        data = json.load(fh)
    data["__kernel_fingerprint__"] = "deadbeefdeadbeef"
    with open(fresh, "w") as fh:
        json.dump(data, fh)
    autotune.clear()
    autotune._load_file(fresh)
    assert "k1" not in autotune._CACHE

    del data["__kernel_fingerprint__"]
    with open(fresh, "w") as fh:
        json.dump(data, fh)
    autotune.clear()
    autotune._load_file(fresh)
    assert "k1" not in autotune._CACHE


def test_fingerprint_folds_in_the_nopad_toggle(monkeypatch):
    monkeypatch.setattr(autotune, "_FINGERPRINT", None)
    monkeypatch.delenv("CESCOIN_XBSP_NOPAD", raising=False)
    padded = autotune.code_fingerprint()
    monkeypatch.setattr(autotune, "_FINGERPRINT", None)
    monkeypatch.setenv("CESCOIN_XBSP_NOPAD", "1")
    assert autotune.code_fingerprint() != padded
    monkeypatch.setattr(autotune, "_FINGERPRINT", None)


def test_tpu_table_is_never_served(fresh, monkeypatch):
    """A JAX package table (its fingerprint, its "tpu" keys) is ignored
    whole; and a "tpu" key under the port's own fingerprint still matches
    no port key, so the arm is measured, not served."""
    rng = np.random.default_rng(1)
    w, al = _aligned(rng, 32, 32, 3)
    jal = jweight_align(jnp.asarray(w), None,
                        policy=JPolicy(block_shape=(8, 8), autotune=True))
    shape = (2, 8, 8, 32)
    jkey = jautotune.cache_key(jal, shape, (1, 1), (1, 1), (1, 1),
                               jnp.float32)
    tpu_key = repr(("tpu",) + ast.literal_eval(jkey)[1:])
    with open(fresh, "w") as fh:
        json.dump({"__kernel_fingerprint__": jautotune.code_fingerprint(),
                   tpu_key: "dense"}, fh)
    autotune._load_file(fresh)
    assert autotune._CACHE == {}

    autotune.clear()
    with open(fresh, "w") as fh:
        json.dump({"__kernel_fingerprint__": autotune.code_fingerprint(),
                   tpu_key: "dense"}, fh)
    measured = []
    monkeypatch.setattr(autotune, "measure",
                        lambda *a, **k: measured.append(1) or {
                            "unroll": 1.0, "dense": 2.0})
    assert conv_ops.measured_arm(al, POL, shape, (1, 1), (1, 1),
                                 (1, 1)) == "unroll"
    assert measured == [1]
    assert tpu_key in autotune._CACHE  # loaded, but never matched


def test_cache_key_layout_and_key_traffic(fresh):
    """The port's key: "cpu" (or "cuda:<name>") first, the other elements
    where the JAX key has them, so that _key_traffic reads it."""
    rng = np.random.default_rng(2)
    _, al = _aligned(rng, 32, 64, 1)
    key = autotune.cache_key(al, (2, 8, 6, 32), (2, 2), (0, 0), (1, 1),
                             torch.bfloat16)
    t = ast.literal_eval(key)
    assert t[0] == "cpu" and t[1] == (2, 8, 6, 32) and t[2] == "torch.bfloat16"
    assert t[3] == (1, 1) and t[4] == (2, 2) and t[8] == 64
    live, union, ncols, nrows = t[11]
    assert (ncols, nrows) == (al.bsc.n_bcols, al.bsc.n_brows)
    assert live == al.bsc.nnz_blocks and union == len(xbs._union(al.bsc))
    assert autotune._key_traffic(key, 3) == 3.0 * (2 * 8 * 6 * 32
                                                   + 2 * 4 * 3 * 64)
    assert autotune._key_traffic("not a key") == 0.0


def test_choose_arm_measures_once_and_caches(fresh, monkeypatch):
    rng = np.random.default_rng(3)
    _, al = _aligned(rng, 32, 32, 3)
    calls = []

    def fake(candidates, x_shape, dtype, device):
        calls.append(x_shape)
        return {"unroll": 3e-6, "gathered": 2e-6, "gathered_cols": 4e-6,
                "dense": 5e-6}

    monkeypatch.setattr(autotune, "measure", fake)
    shape = (1, 6, 6, 32)
    logs = []
    args = (al, POL, shape, (1, 1), (1, 1), (1, 1))
    assert conv_ops.measured_arm(*args, log=logs.append) == "gathered"
    assert conv_ops.measured_arm(*args) == "gathered"
    assert calls == [shape]
    assert "gathered" in logs[0]
    key = autotune.cache_key(al, shape, (1, 1), (1, 1), (1, 1),
                             torch.float32)
    assert autotune.report()[key]["gathered"] == 2e-6
    with open(fresh) as fh:
        assert json.load(fh)[key] == "gathered"
    # the dispatcher takes it: best_arm after the block-density gate
    assert conv_ops.best_arm(al, POL, x_shape=shape,
                             padding=(1, 1)) == "gathered"
    route = conv_ops.conv_route(torch.empty(shape, device="meta"), al,
                                padding=(1, 1), mode=ConvMode.SCONV_PAR,
                                policy=POL)
    assert route == "gathered"


@pytest.mark.parametrize("failing", ["conv_gathered", "sconv"])
def test_an_arm_that_raises_fails_the_measurement(fresh, monkeypatch,
                                                  failing):
    """No candidate drops out quietly: an XBSP arm, or the fused kernel
    (offered where it runs the shape, with no switch), that raises fails
    measured_arm, and nothing is cached."""
    from caffe_escoin_tpu_torch.kernels import sconv_fused

    rng = np.random.default_rng(6)
    _, al = _aligned(rng, 32, 32, 3)

    def boom(*args, **kwargs):
        raise RuntimeError(f"{failing} failed")

    monkeypatch.setattr(xbs if failing == "conv_gathered" else sconv_fused,
                        failing, boom)
    with pytest.raises(RuntimeError, match=f"{failing} failed"):
        conv_ops.measured_arm(al, POL, (1, 6, 6, 32), (1, 1), (1, 1),
                              (1, 1))
    assert autotune.report() == {} and autotune._CACHE == {}


def test_choose_arm_is_not_reentrant(fresh, monkeypatch):
    rng = np.random.default_rng(4)
    _, al = _aligned(rng, 32, 32, 3)
    monkeypatch.setattr(autotune._MEASURING, "active", True, raising=False)
    assert conv_ops.measured_arm(al, POL, (1, 6, 6, 32), (1, 1), (1, 1),
                                 (1, 1)) is None
    # best_arm then falls back to the heuristic
    assert conv_ops.best_arm(al, POL, x_shape=(1, 6, 6, 32)) == "unroll"


@pytest.mark.parametrize("case", ["fused", "over_budget", "dilated"])
def test_measure_arms_times_every_candidate(fresh, monkeypatch, case):
    """On CPU tensors (host clock): the four arms, and the direct kernel's
    plain version where the dispatcher would run it, with no switch: not
    on a shape over the reference's size budget, nor on a dilated conv,
    which the kernel does not take; each time positive."""
    from caffe_escoin_tpu_torch.kernels import sconv_fused

    if case == "over_budget":
        monkeypatch.setattr(sconv_fused, "VMEM_BUDGET", 1024)
    dilation = (2, 2) if case == "dilated" else (1, 1)
    rng = np.random.default_rng(5)
    _, al = _aligned(rng, 16, 16, 3)
    shape = (1, 5, 5, 16)
    arms = conv_ops.conv_arms(torch.empty(shape, device="meta"), al,
                              stride=(1, 1), padding=dilation,
                              dilation=dilation, policy=POL)
    times = autotune.measure(arms, shape, torch.float32, torch.device("cpu"),
                             iters=2)
    expect = {"unroll", "gathered", "gathered_cols", "dense"}
    assert set(times) == (expect | {"fused"} if case == "fused" else expect)
    assert all(t > 0 for t in times.values())


@pytest.mark.parametrize("supported, fits", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_fused_is_offered_exactly_where_its_gate_passes(
        fresh, monkeypatch, supported, fits):
    """The candidate set comes from the policy and the shape alone: the
    fused kernel competes exactly where ``sconv_fused.supported`` and
    ``fits_budget`` both pass (``ops.conv.fused_gate``), and no environment
    variable is read."""
    from caffe_escoin_tpu_torch.kernels import sconv_fused

    for name in [k for k in os.environ if k.startswith("CESCOIN_")]:
        monkeypatch.delenv(name)
    monkeypatch.setattr(sconv_fused, "supported",
                        lambda *a, **k: supported)
    monkeypatch.setattr(sconv_fused, "fits_budget", lambda *a, **k: fits)
    offered = []
    monkeypatch.setattr(benchmark, "device_time_arms",
                        lambda arms, sets, iters: offered.append(set(arms))
                        or {a: 1.0 for a in arms})
    rng = np.random.default_rng(7)
    _, al = _aligned(rng, 16, 16, 3)
    conv_ops.measured_arm(al, POL, (1, 5, 5, 16), (1, 1), (1, 1), (1, 1))
    assert ("fused" in offered[0]) == (supported and fits)
    assert offered[0] - {"fused"} == {"unroll", "gathered", "gathered_cols",
                                      "dense"}


@pytest.mark.parametrize("case", ["fused", "over_budget", "dilated"])
def test_conv_candidates_come_in_order(monkeypatch, case):
    """``ops.conv.conv_arms`` names a conv's candidates in this order:
    unroll, gathered, gathered_cols, dense, then fused exactly where
    ``fused_gate`` admits the shape (not over the reference's size budget,
    not dilated)."""
    from caffe_escoin_tpu_torch.kernels import sconv_fused

    if case == "over_budget":
        monkeypatch.setattr(sconv_fused, "VMEM_BUDGET", 1024)
    dilation = (2, 2) if case == "dilated" else (1, 1)
    _, al = _aligned(np.random.default_rng(5), 16, 16, 3)
    x = torch.empty((1, 5, 5, 16), dtype=torch.bfloat16, device="meta")
    arms = conv_ops.conv_arms(x, al, stride=(1, 1), padding=dilation,
                              dilation=dilation, policy=POL)
    admits = conv_ops.fused_gate(x, al, dilation, dilation=dilation)
    assert admits == (case == "fused")
    assert list(arms) == ["unroll", "gathered", "gathered_cols", "dense"] + (
        ["fused"] if admits else [])


# ---- the fc's arms ---------------------------------------------------------

def _fc(rng, k=64, n=32, sparsity=0.75, policy=POL):
    """A pruned fc weight [K, N] aligned as InnerProduct aligns it: (its
    BSC, its dense [K, N], a bias)."""
    w = prune_conv_weight(rng.standard_normal((1, 1, k, n)).astype(
        np.float32), sparsity, (8, 8))
    al = weight_align(w, policy=policy)
    return al.bsc, al.dense.reshape(k, n), torch.randn(n)


def test_fc_keys_are_their_own_and_conv_keys_are_unchanged(fresh):
    """A conv key is the repr of the tuple it has always been; an fc key
    starts with "fc" and equals no conv key, on the same weight too."""
    rng = np.random.default_rng(8)
    _, al = _aligned(rng, 32, 64, 1)
    key = autotune.cache_key(al, (2, 8, 6, 32), (2, 2), (0, 0), (1, 1),
                             torch.bfloat16, "bfloat16")
    assert key == repr(("cpu", (2, 8, 6, 32), "torch.bfloat16", (1, 1),
                        (2, 2), (0, 0), (1, 1), al.cin_pad, al.cout,
                        al.groups, (8, 8), autotune._pattern_sig(al)))
    fkey = autotune.fc_cache_key(al.bsc, 2, torch.bfloat16, "bfloat16")
    t = ast.literal_eval(fkey)
    assert t == ("fc", "cpu", 2, "torch.bfloat16", tuple(al.bsc.shape),
                 (8, 8), autotune._pattern_sig(al))
    assert fkey != key and not fkey.startswith("('cpu'")
    assert autotune._key_traffic(fkey, 2) == 2.0 * 2 * sum(al.bsc.shape)
    assert autotune.fc_cache_key(al.bsc, 3, torch.bfloat16,
                                 "bfloat16") != fkey
    f32 = autotune.fc_cache_key(al.bsc, 2, torch.bfloat16, "float32")
    assert f32 == fkey[:-1] + ", 'float32')"


@pytest.mark.parametrize("fastest", ["dense", "bsc_spmm", "xbsp_spmm"])
def test_fc_arms_are_timed_in_turn_and_the_fastest_wins(fresh, monkeypatch,
                                                        fastest):
    """The three arms, each with the bias and ReLU epilogue, timed through
    ``device_time_arms`` on a counting clock (each call advances it by its
    arm's cost): every arm runs each input set once eagerly, then round i
    runs every arm once on set i % 4; the cheapest arm is picked."""
    clock = {"t": 0.0}
    cost = {"xbsp_spmm": 3.0, "bsc_spmm": 2.0, "dense": 4.0}
    cost[fastest] = 1.0
    seen = []
    sets = {}

    def fake(arm, x2d, *, sparse_w, bias, relu, policy, dense):
        assert relu and bias is not None and dense.shape == sparse_w.shape
        seen.append((arm, sets.setdefault(x2d.data_ptr(), len(sets))))
        clock["t"] += cost[arm]

    monkeypatch.setattr(linear_ops, "run_fc_arm", fake)
    monkeypatch.setattr(benchmark, "time", type("clock", (), {
        "perf_counter": staticmethod(lambda: clock["t"])}))
    bsc, dense, bias = _fc(np.random.default_rng(9))
    arm = linear_ops.fc_arm(bsc, POL, 4, bias=bias, relu=True, dense=dense)
    assert arm == fastest
    arms = ["xbsp_spmm", "bsc_spmm", "dense"]
    eager = [(a, i) for a in arms for i in range(4)]
    assert seen[:12] == eager
    assert seen[12:] == [(a, i % 4) for i in range(10) for a in arms]
    key = autotune.fc_cache_key(bsc, 4, torch.float32)
    assert autotune.report()[key] == {a: cost[a] for a in arms}


def test_fc_pick_is_cached_and_not_measured_again(fresh, monkeypatch):
    measured = []
    monkeypatch.setattr(autotune, "measure",
                        lambda *a, **k: measured.append(1) or {
                            "xbsp_spmm": 3.0, "bsc_spmm": 2.0, "dense": 1.0})
    bsc, dense, bias = _fc(np.random.default_rng(10))
    args = (bsc, POL, 4)
    kw = dict(bias=bias, dense=dense)
    assert linear_ops.fc_arm(*args, **kw) == "dense"
    assert linear_ops.fc_arm(*args, **kw) == "dense"
    assert measured == [1]
    key = autotune.fc_cache_key(bsc, 4, torch.float32)
    with open(fresh) as fh:
        assert json.load(fh)[key] == "dense"
    autotune.clear()  # from the file, not measured again
    assert linear_ops.fc_arm(*args, **kw) == "dense" and measured == [1]


@pytest.mark.parametrize("kind", ["conv", "fc"])
def test_a_measurement_during_capture_raises(fresh, monkeypatch, kind):
    """On the card, a key not cached when a CUDA graph is being captured
    raises, for an fc as for a conv: nothing is measured inside a
    capture."""
    import dataclasses
    import types

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(autotune, "measure", lambda *a, **k: pytest.fail(
        "measured during a capture"))
    rng = np.random.default_rng(11)
    if kind == "conv":
        _, al = _aligned(rng, 32, 32, 3)
        bsc = al.bsc
    else:
        bsc, dense, bias = _fc(rng)
    # the weight as if it were on the card (its blocks report is_cuda)
    blocks = types.SimpleNamespace(device=torch.device("cpu"), is_cuda=True)
    card = types.SimpleNamespace(blocks=blocks, shape=bsc.shape,
                                 block_shape=bsc.block_shape,
                                 memo={"sig": autotune._bsc_sig(bsc)})
    with pytest.raises(RuntimeError, match="during CUDA-graph capture"):
        if kind == "conv":
            al = dataclasses.replace(al, bsc=card)
            conv_ops.measured_arm(al, POL, (1, 6, 6, 32), (1, 1), (1, 1),
                                  (1, 1))
        else:
            linear_ops.fc_arm(card, POL, 4, bias=bias, dense=dense)
    assert autotune._CACHE == {}


@pytest.mark.parametrize("xla", [True, False])
def test_autotune_off_leaves_the_fc_routes(fresh, monkeypatch, xla):
    """Without autotune an fc runs as it always has: the XBSP ``spmm`` on
    the XBSP branch, as in the JAX package, and the ``bsc_spmm`` kernel on
    the kernel routes; nothing is measured. With autotune on, the route
    is the measured pick ("bsc_spmm" named "spmm")."""
    import dataclasses

    from caffe_escoin_tpu_torch.kernels import bsc_spmm
    from caffe_escoin_tpu_torch.nn import Net
    from caffe_escoin_tpu_torch.nn.net import LayerSpec

    ran = []
    monkeypatch.setattr(autotune, "measure",
                        lambda *a, **k: ran.append("measured") or {
                            "xbsp_spmm": 3.0, "bsc_spmm": 1.0, "dense": 2.0})
    for mod, name in ((xbs, "spmm"), (bsc_spmm, "bsc_spmm")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            ran.append(_n), _r(*a, **k))[1])
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(8, 8),
                          use_xla_sparse=xla)
    spec = LayerSpec("fc", "InnerProduct", ("data",),
                     params=dict(num_output=32))
    rng = np.random.default_rng(12)
    w = prune_conv_weight(rng.standard_normal((1, 1, 64, 32)).astype(
        np.float32), 0.75, (8, 8))[0, 0]
    x = torch.randn(4, 64)
    for autotuned in (False, True):
        p = dataclasses.replace(pol, autotune=autotuned)
        net = Net([spec], policy=p)
        aligned = net.weight_align({"fc": {"w": torch.from_numpy(w),
                                           "b": torch.zeros(32)}})
        ran.clear()
        route = net.routes(aligned, {"data": (4, 64)})["fc"]
        out = net.forward(aligned, {"data": x})["fc"]
        torch.testing.assert_close(out, x @ torch.from_numpy(w),
                                   rtol=1e-4, atol=1e-4)
        if not autotuned:
            assert route == ("xbsp_spmm" if xla else "spmm")
            assert ran == ["spmm" if xla else "bsc_spmm"]
        else:
            assert route == "spmm" and ran == ["measured", "bsc_spmm"]


def test_calibrate_polish_tries_an_fcs_own_arms(fresh):
    """calibrate_graph counts the fc keys among the sparse keys, and its
    polish offers an fc key only the fc's arms that run every shape."""
    rng = np.random.default_rng(13)
    bsc, dense, bias = _fc(rng)
    key = autotune.fc_cache_key(bsc, 4, torch.float32)
    autotune._CACHE[key] = "xbsp_spmm"
    tried = []

    def time_fn():
        arm = linear_ops.fc_arm(bsc, POL, 4, bias=bias, dense=dense)
        tried.append(arm)
        return {"xbsp_spmm": 1.0, "dense": 2.0, "bsc_spmm": 0.5}[arm]

    rep = autotune.calibrate_graph(time_fn, polish=8, log=lambda m: None)
    assert rep["sparse_keys"] == 1
    assert set(tried) == {"xbsp_spmm", "dense", "bsc_spmm"}
    assert rep["arms"] == {key: "bsc_spmm"}


def test_device_time_cycles_its_argument_sets():
    seen = []
    t = device_time(lambda a: seen.append(int(a[0])), torch.zeros(1),
                    iters=8, arg_sets=[(torch.full((1,), i),)
                                       for i in range(4)])
    assert t >= 0
    assert seen == [0, 1, 2, 3] + [0, 1, 2, 3] * 2


def test_device_time_arms_times_the_arms_in_turn():
    """Every arm runs each set once eagerly; then round i runs every arm
    once on set i % 4."""
    seen = []

    def arm(name):
        return lambda a: seen.append((name, int(a[0])))

    times = benchmark.device_time_arms(
        {"a": arm("a"), "b": arm("b")},
        [(torch.full((1,), i),) for i in range(4)], iters=6)
    assert set(times) == {"a", "b"} and all(t >= 0 for t in times.values())
    eager = [("a", i) for i in range(4)] + [("b", i) for i in range(4)]
    assert seen == eager + [(n, i % 4) for i in range(6) for n in "ab"]


def test_arms_in_turn_outlast_a_slowdown_of_one_arms_length(monkeypatch):
    """A slowdown of the device that lasts as long as one arm's timed
    calls, timed one arm after another, makes the fast arm read slower
    than the slow one; timed in turn it falls on both arms alike, and the
    fast arm reads faster. The clock is a counter that each call advances
    by its arm's cost, plus 5 during the first 10 timed calls."""
    clock = {"t": 0.0, "calls": 0, "slow_from": 0}
    cost = {"fast": 1.0, "slow": 1.5}

    def arm(name):
        def f(y):
            clock["calls"] += 1
            late = clock["calls"] - clock["slow_from"]
            clock["t"] += cost[name] + (5.0 if 0 <= late < 10 else 0.0)
        return f

    arms = {"fast": arm("fast"), "slow": arm("slow")}
    sets = [(torch.zeros(1),) for _ in range(4)]
    monkeypatch.setattr(benchmark, "time", type("clock", (), {
        "perf_counter": staticmethod(lambda: clock["t"])}))
    # in turn: 8 eager calls, then the rounds
    clock.update(t=0.0, calls=0, slow_from=9)
    times = benchmark.device_time_arms(arms, sets, iters=10)
    assert times["fast"] < times["slow"]
    # one after another: the fast arm's 4 eager calls, then its 10 timed
    clock.update(t=0.0, calls=0, slow_from=5)
    one_by_one = {n: device_time(f, *sets[0], iters=10, arg_sets=sets)
                  for n, f in arms.items()}
    assert one_by_one["fast"] > one_by_one["slow"]
