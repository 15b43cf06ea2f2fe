"""The port's autotune (caffe_escoin_tpu_torch.engine.autotune) on the
deterministic cases of the JAX package's tests/test_autotune.py, and what
the port adds: its cache key and fingerprint, a TPU table never served, and
``choose_arm`` with the measurement replaced, so nothing is timed.

``time_fn`` consults ``choose_arm`` as a whole forward does, but returns a
crafted cost model, so every decision of ``calibrate_graph`` is exact.
"""

import ast
import json

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
    monkeypatch.delenv("CESCOIN_AUTOTUNE_FUSED", raising=False)
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
        """What a whole forward does: ask choose_arm per conv site (key_a
        twice: multiplicity)."""
        a1 = autotune.choose_arm(a, POL, shape, (1, 1), (1, 1), (1, 1))
        autotune.choose_arm(a, POL, shape, (1, 1), (1, 1), (1, 1))
        a2 = autotune.choose_arm(b, POL, shape, (1, 1), (0, 0), (1, 1))
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
    monkeypatch.setattr(autotune, "measure_arms",
                        lambda *a, **k: measured.append(1) or {
                            "unroll": 1.0, "dense": 2.0})
    assert autotune.choose_arm(al, POL, shape, (1, 1), (1, 1),
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

    def fake(aligned, policy, x_shape, stride, padding, dilation):
        calls.append(x_shape)
        return {"unroll": 3e-6, "gathered": 2e-6, "gathered_cols": 4e-6,
                "dense": 5e-6}

    monkeypatch.setattr(autotune, "measure_arms", fake)
    shape = (1, 6, 6, 32)
    logs = []
    args = (al, POL, shape, (1, 1), (1, 1), (1, 1))
    assert autotune.choose_arm(*args, log=logs.append) == "gathered"
    assert autotune.choose_arm(*args) == "gathered"
    assert calls == [shape]
    assert "gathered" in logs[0]
    key = autotune.cache_key(al, shape, (1, 1), (1, 1), (1, 1),
                             torch.float32)
    assert autotune.report()[key]["gathered"] == 2e-6
    with open(fresh) as fh:
        assert json.load(fh)[key] == "gathered"
    # the dispatcher takes it: best_arm after the block-density gate
    assert xbs.best_arm(al, POL, x_shape=shape, padding=(1, 1)) == "gathered"
    route = conv_ops.conv_route(torch.empty(shape, device="meta"), al,
                                padding=(1, 1), mode=ConvMode.SCONV_PAR,
                                policy=POL)
    assert route == "gathered"


@pytest.mark.parametrize("failing", ["conv_gathered", "sconv"])
def test_an_arm_that_raises_fails_the_measurement(fresh, monkeypatch,
                                                  failing):
    """No candidate drops out quietly: an XBSP arm, or the fused kernel
    offered under CESCOIN_AUTOTUNE_FUSED, that raises fails choose_arm,
    and nothing is cached."""
    from caffe_escoin_tpu_torch.kernels import sconv_fused

    monkeypatch.setenv("CESCOIN_AUTOTUNE_FUSED", "1")
    rng = np.random.default_rng(6)
    _, al = _aligned(rng, 32, 32, 3)

    def boom(*args, **kwargs):
        raise RuntimeError(f"{failing} failed")

    monkeypatch.setattr(xbs if failing == "conv_gathered" else sconv_fused,
                        failing, boom)
    with pytest.raises(RuntimeError, match=f"{failing} failed"):
        autotune.choose_arm(al, POL, (1, 6, 6, 32), (1, 1), (1, 1), (1, 1))
    assert autotune.report() == {} and autotune._CACHE == {}


def test_choose_arm_is_not_reentrant(fresh, monkeypatch):
    rng = np.random.default_rng(4)
    _, al = _aligned(rng, 32, 32, 3)
    monkeypatch.setattr(autotune._MEASURING, "active", True, raising=False)
    assert autotune.choose_arm(al, POL, (1, 6, 6, 32), (1, 1), (1, 1),
                               (1, 1)) is None
    # best_arm then falls back to the heuristic
    assert xbs.best_arm(al, POL, x_shape=(1, 6, 6, 32)) == "unroll"


@pytest.mark.parametrize("fused", [False, True, "over_budget"])
def test_measure_arms_times_every_candidate(fresh, monkeypatch, fused):
    """On CPU tensors (host clock): the four arms, and the direct kernel's
    plain version with CESCOIN_AUTOTUNE_FUSED where the dispatcher would
    run it (not on a shape over the reference's size budget); each time
    positive."""
    from caffe_escoin_tpu_torch.kernels import sconv_fused

    if fused:
        monkeypatch.setenv("CESCOIN_AUTOTUNE_FUSED", "1")
    if fused == "over_budget":
        monkeypatch.setattr(sconv_fused, "VMEM_BUDGET", 1024)
    rng = np.random.default_rng(5)
    _, al = _aligned(rng, 16, 16, 3)
    times = autotune.measure_arms(al, POL, (1, 5, 5, 16), (1, 1), (1, 1),
                                  (1, 1), iters=2)
    expect = {"unroll", "gathered", "gathered_cols", "dense"}
    assert set(times) == (expect | {"fused"} if fused is True else expect)
    assert all(t > 0 for t in times.values())


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
