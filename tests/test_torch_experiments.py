"""The port's probes (caffe_escoin_tpu_torch/experiments/) against the
JAX package's functions and the reference scripts, on the CPU at small
sizes.

* ``pool``: the four candidates equal each other and the script's
  ``pool_rw``, ``pool_slice9`` and ``pool_twopass`` (``scripts/
  exp_pool_r5.py``, loaded by path; its ``main`` is not run; ``hand``
  against ``pool_rw``) exactly, on
  its six geometries at batch 2 and 8 channels, in bf16;
* ``k3``: the XBSP arms against ``caffe_escoin_tpu.kernels.
  xla_block_sparse``'s on the same aligned weight, f32, rtol 1e-4 /
  atol 1e-5; the run's rows within phase 3's rule, 1e-2 * max|ref| + 1e-2,
  of the f32 reference, no error row;
* ``s2d``: each stem's fold against the JAX package's fold
  (``ops/s2d.s2d_input`` + ``conv2d_dense`` in bf16), within 1e-2 *
  max|ref| (one bf16 rounding apart);
* ``wpack``: the packed tower against the unpacked one and against the
  script's JAX towers on the same bf16 inputs and weights, within 1e-2 *
  max|ref| + 1e-2;
* ``opprofile``: both forms' rows and kernel tables on a CPU profile of
  LeNet, ``Net.forward`` with the program's tracing on bit-equal to it
  with tracing off;
* ``stability`` and ``rss_probe``: their rows on LeNet for a few
  iterations with ``--platform cpu`` (stability's phases in processes of
  their own);
* every probe's ``--platform cuda`` without a card exits 2, and none
  writes under the JAX package's paths.
"""

import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import xla_block_sparse as jxbs  # noqa: E402
from caffe_escoin_tpu.ops import s2d as js2d  # noqa: E402
from caffe_escoin_tpu.ops import wpack as jwpack  # noqa: E402
from caffe_escoin_tpu.ops.conv import conv2d_dense as jconv2d_dense  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402

from caffe_escoin_tpu_torch.engine import autotune  # noqa: E402
from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu_torch.experiments import (common, k3, opprofile,  # noqa: E402
                                                pool, rss_probe, s2d,
                                                stability, wpack)
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs  # noqa: E402
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PARITY_REL, PARITY_ABS = 1e-2, 1e-2
TOL = dict(rtol=1e-4, atol=1e-5)
PROBES = ("opprofile", "pool", "k3", "s2d", "wpack", "stability",
          "rss_probe")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_pool = _load_script("exp_pool_r5")


def _collect():
    rows = []

    def emit(**row):
        row = {**row, "device": "cpu"}
        rows.append(row)
        return row

    return rows, emit


@pytest.fixture
def autotune_scratch(tmp_path, monkeypatch):
    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    yield
    autotune.clear()


# ---- pool ------------------------------------------------------------------

@pytest.mark.parametrize("case", pool.SHAPES, ids=[c[-1] for c in pool.SHAPES])
def test_pool_candidates_equal_the_scripts(case):
    shape, k, s, p, tag = case
    assert (shape, k, s, p, tag) in ref_pool.SHAPES
    small = (2,) + tuple(shape[1:3]) + (8,)
    x = np.random.default_rng(0).standard_normal(small).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    outs = {name: fn(xt, k, s, p).float().numpy()
            for name, fn in pool.CANDIDATES}
    refs = {"rw": ref_pool.pool_rw, "slice9": ref_pool.pool_slice9,
            "twopass": ref_pool.pool_twopass, "hand": ref_pool.pool_rw}
    for name, out in outs.items():
        assert np.array_equal(out, outs["rw"]), name
        ref = np.asarray(refs[name](xj, k, s, p), np.float32)
        assert np.array_equal(out, ref), name


def test_pool_rows():
    rows, emit = _collect()
    cases = [((2,) + c[0][1:3] + (4,),) + c[1:] for c in pool.SHAPES[:3]]
    pool.run(CPU, emit, shapes=cases, iters=2)
    assert [r["tag"] for r in rows] == [c[-1] for c in cases]
    for r in rows:
        assert r["kind"] == "pool_ab"
        assert all(r[f"t_{n}_us"] > 0 for n, _ in pool.CANDIDATES)


# ---- k3 --------------------------------------------------------------------

@pytest.mark.parametrize("arm", ["conv", "conv_gathered_cols"])
def test_k3_xbsp_arms_match_jax(arm):
    rng = np.random.default_rng(0)
    w = prune_conv_weight(rng.standard_normal((3, 3, 64, 64)).astype(
        np.float32) * .05, 0.75, (16, 16))
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    out = getattr(xbs, arm)(torch.from_numpy(x), weight_align(
        w, None, policy=ExecutionPolicy(block_shape=(16, 16))),
        padding=(1, 1))
    ref = getattr(jxbs, arm)(jnp.asarray(x), jweight_align(
        w, None, policy=JPolicy(block_shape=(16, 16))), stride=(1, 1),
        padding=(1, 1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_k3_rows_meet_phase_3s_rule():
    rows, emit = _collect()
    k3.run(CPU, emit, hws=(7,), batch=1, iters=2)
    names = [r["arm"] for r in rows]
    assert names[:4] == ["unroll", "gathered_cols", "dense_bf16",
                         "fused_cuda"]
    assert names[4].startswith("bbox")
    assert names[5:] == ["prepad_unroll", "padonly", "prod_concat_plain",
                         "prod_concat_padded", "prod_single_plain",
                         "prod_single_padded"]
    for r in rows:
        assert "error" not in r, r
        assert r["shape"] == "7x7 512->512 k3 b1" and r["us"] > 0
        assert r["err"] <= PARITY_REL * r["ref_max"] + PARITY_ABS, r
    assert rows[4]["live"] > 0 and rows[4]["offsets"].startswith("[(")


def test_k3_arm_that_raises_gives_an_error_row(monkeypatch):
    rows, emit = _collect()

    def broken(*a, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(k3.xbs, "conv_gathered_cols", broken)
    k3.run(CPU, emit, hws=(7,), batch=1, iters=1, arms="unroll,gcols")
    assert [r["arm"] for r in rows] == ["unroll", "gathered_cols"]
    assert "error" not in rows[0] and "boom" in rows[1]["error"]


# ---- s2d -------------------------------------------------------------------

@pytest.mark.parametrize("case", s2d.CASES, ids=[c[0] for c in s2d.CASES])
def test_s2d_fold_matches_jax(case):
    tag, ishape, cout, k, r, p = case
    rng = np.random.default_rng(0)
    w = rng.standard_normal((k, k, 3, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32) * 0.1
    x = rng.standard_normal((1,) + tuple(ishape[1:])).astype(np.float32)
    stock, folded = s2d.stems(w, b, r, p, CPU)
    xt = torch.from_numpy(x)
    got, base = folded(xt).float().numpy(), stock(xt).float().numpy()
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jconv2d_dense(
        js2d.s2d_input(xj, r, (k, k), (p, p)),
        jnp.asarray(js2d.s2d_weight(w, r, (p, p)), jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), stride=(1, 1), padding=(0, 0),
        relu=True), np.float32)
    assert got.shape == ref.shape == base.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= PARITY_REL * scale
    assert np.abs(got - base).max() <= s2d.REL_TOL * np.abs(base).max()


def test_s2d_rows():
    rows, emit = _collect()
    s2d.run(CPU, emit, cases=[(t, (1, 40, 40, 3), 8, k, r, p)
                              for t, _, _, k, r, p in s2d.CASES], iters=2)
    assert [r["tag"] for r in rows] == [c[0] for c in s2d.CASES]
    for r in rows:
        assert r["kind"] == "s2d_ab" and r["rel_err"] <= s2d.REL_TOL
        assert r["t_stock_us"] > 0 and r["t_s2d_us"] > 0


# ---- wpack -----------------------------------------------------------------

def _jax_towers(b, w_entry, w_k3, w_exit):
    """The script's two towers (exp_wpack_r5.py:185-206) on the JAX
    package, its weights built by the JAX wpack functions."""
    r, hw = b["r"], b["hw"]
    dn = ("NHWC", "HWIO", "NHWC")
    bf = jnp.bfloat16
    aligned = jweight_align(w_k3, None, policy=JPolicy(
        block_shape=(128, 128), compute_dtype=bf, cast_back=False))
    wp_k3, (pl3, _) = jwpack.packed_weight(w_k3, r, 1)
    pr3 = jwpack.packed_pad_right(hw, 3, 1, r)
    tap_nz = np.abs(wp_k3).sum(axis=(2, 3)) > 0
    rs, cs = np.where(tap_nz.any(axis=1))[0], np.where(tap_nz.any(axis=0))[0]
    r0, r1, c0, c1 = rs.min(), rs.max(), cs.min(), cs.max()
    wpc = jnp.asarray(wp_k3[r0:r1 + 1, c0:c1 + 1], bf)
    cpad = [(1 - r0, r1 - 1), (pl3 - c0, c1 - (wp_k3.shape[1] - 1) + pr3)]
    we_p, (epl, _), esw = jwpack.entry_weight(w_entry, r, 1, 0)
    epr = jwpack.entry_pad_right(hw, 1, 1, 0, r)
    wx_p, (xpl, _), xdil = jwpack.exit_weight(w_exit, r, 0)
    xpr = jwpack.exit_pad_right(hw // r, 1, 0, r)
    we_b, wx_b = jnp.asarray(w_entry, bf), jnp.asarray(w_exit, bf)

    def unpacked(y):
        a = jnp.maximum(lax.conv_general_dilated(
            y, we_b, (1, 1), [(0, 0), (0, 0)], dimension_numbers=dn), 0)
        c = jxbs.conv(a, aligned, stride=(1, 1), padding=(1, 1), relu=True)
        o = lax.conv_general_dilated(c, wx_b, (1, 1), [(0, 0), (0, 0)],
                                     dimension_numbers=dn)
        return jnp.maximum(o + y, 0)

    def packed(y):
        a = jnp.maximum(lax.conv_general_dilated(
            y, jnp.asarray(we_p, bf), (1, esw), [(0, 0), (epl, epr)],
            dimension_numbers=dn), 0)
        c = jnp.maximum(lax.conv_general_dilated(
            a, wpc, (1, 1), cpad, dimension_numbers=dn), 0)
        o = lax.conv_general_dilated(
            c, jnp.asarray(wx_p, bf), (1, 1), [(0, 0), (xpl, xpr)],
            lhs_dilation=(1, xdil), dimension_numbers=dn)
        return jnp.maximum(o + y, 0)

    return unpacked, packed


def test_wpack_towers_match_each_other_and_jax():
    shape = dict(batch=2, hw=8, cin=64, big=128, sparsity=0.9)
    b = wpack.build(CPU, **shape)
    # the script's draws, in its order (exp_wpack_r5.py:85-95)
    rng = np.random.default_rng(0)
    n, hw, c, big = 2, 8, 64, 128
    for _ in range(8):
        rng.standard_normal((n, hw, hw, big if _ < 4 else c))
    w_entry = rng.standard_normal((1, 1, big, c)).astype(np.float32) * .05
    w_k3 = prune_conv_weight(rng.standard_normal((3, 3, c, c)).astype(
        np.float32) * .05, 0.9, (128, 128))
    w_exit = rng.standard_normal((1, 1, c, big)).astype(np.float32) * .05
    x = b["xbig"][0]
    for check in ("k3", "entry", "exit"):
        err, scale = b["errs"][check]
        assert err <= PARITY_REL * scale + PARITY_ABS, check
    packed = b["tower_packed"](x).float().numpy()
    unpacked = b["tower_unpacked"](x).float().numpy()
    limit = PARITY_REL * np.abs(unpacked).max() + PARITY_ABS
    assert np.abs(packed - unpacked).max() <= limit
    assert b["errs"]["tower"][0] <= limit
    j_unpacked, j_packed = _jax_towers(b, w_entry, w_k3, w_exit)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    for got, ref in ((packed, j_packed(xj)), (unpacked, j_unpacked(xj))):
        ref = np.asarray(ref, np.float32)
        assert np.abs(got - ref).max() <= PARITY_REL * np.abs(ref).max() \
            + PARITY_ABS


def test_wpack_rows():
    rows, emit = _collect()
    wpack.run(CPU, emit, iters=2, batch=1, hw=8, cin=64, big=64)
    assert [r["arm"] for r in rows] == [
        "k3_unpacked", "k3_packed_conv", "k3_packed_xbsp", "entry_unpacked",
        "entry_packed", "exit_unpacked", "exit_packed", "tower_unpacked",
        "tower_packed"]
    for r in rows:
        assert "error" not in r and r["shape"] == "8x8 c64 r2 b1"
        assert r["us"] > 0
    assert all(rows[i]["max_err"] <= PARITY_REL * rows[i]["ref_max"]
               + PARITY_ABS for i in (0, 1, 3, 5, 7))


# ---- opprofile -------------------------------------------------------------

def test_opprofile_lenet_cpu_profile(autotune_scratch):
    rows, emit = _collect()
    out = opprofile.run(CPU, emit, net_name="lenet", batch=2, iters=3,
                        top=8)
    assert set(out) == {"graph", "eager"}
    layer_names = {"conv1", "pool1", "conv2", "pool2", "ip1", "relu1",
                   "ip2", "prob"}
    for form, (row, krows) in out.items():
        assert row["kind"] == "opprofile" and row["form"] == form
        assert row["net"] == "lenet" and row["iters"] == 3
        assert row["kernels_seen"] and row["distinct_kernels"] >= 8
        assert row["module_total_ms_per_iter"] > 0 and row["graph_ms"] > 0
        assert set(row["hand_calls_per_iter"]) == set(
            opprofile.KERNEL_MODULES)
        assert row["launches_per_iter"] == {k: 0.0 for k in
                                            opprofile.KERNEL_MODULES}
        assert [k["rank"] for k in krows] == list(range(1, 9))
        shares = [k["share"] for k in krows]
        assert shares == sorted(shares, reverse=True) and sum(shares) <= 1
        assert all(k["kind"] == "opprofile_kernel" and k["form"] == form
                   for k in krows)
    eager_layers = {k["layer"] for k in out["eager"][1]}
    assert eager_layers and eager_layers <= layer_names
    assert len(rows) == 2 + 2 * 8


def test_opprofile_profile_keeps_no_event_of_its_warm_up():
    """``_profile`` runs one warm-up call first (``fn(iters)``), whose
    events the profiler drops, then records ``fn(0)`` to
    ``fn(iters - 1)``; its step marks are no ops for ``aggregate``."""
    def fn(i):
        with torch.profiler.record_function(f"opp_call_{i}"):
            torch.ones(4) + i

    events, launched = opprofile._profile(fn, 3, cuda=False)
    names = {e.name for e in events}
    assert {f"opp_call_{i}" for i in range(4)} & names == {
        "opp_call_0", "opp_call_1", "opp_call_2"}
    assert launched == {k: 0 for k in opprofile.KERNEL_MODULES}
    records, _ = opprofile.aggregate(events, cuda=False)
    assert not [n for n in records if n.startswith("ProfilerStep")]


def test_traced_net_forward_is_untraced_bit_for_bit(autotune_scratch):
    """The eager form's forward: ``Net.forward`` with tracing on gives the
    blobs it gives with tracing off."""
    from caffe_escoin_tpu_torch.utils import trace

    s = common.sparse_net("lenet", 2, CPU)
    with autotune.net_scope("lenet"), torch.inference_mode():
        want = s.net.forward(s.aligned, {"data": s.xs[1]},
                             return_blobs=True)
        trace.enable()
        try:
            got = s.net.forward(s.aligned, {"data": s.xs[1]},
                                return_blobs=True)
        finally:
            trace.disable()
            trace.reset()
    assert set(got) == set(want)
    assert all(torch.equal(got[b], want[b]) for b in want)


def test_kernel_names_map_to_the_hand_kernels():
    for name, kernel in (
            ("void sconv_pipe_kernel<__nv_bfloat16, 64, 64, "
             "ConvRows<__nv_bfloat16>, false>(...)", "sconv_fused"),
            ("_Z17sconv_pipe_kernelIfLi64ELi32E8SlabRowsIfELb0EEvT2_4Args",
             "sconv_gc"),
            ("void sconv_pipe_kernel<float, 64, 64, DenseRows<float>, "
             "true>(...)", "bsc_spmm"),
            ("ampere_bf16_s16816gemm", "ampere_bf16_s16816gemm")):
        assert opprofile.kernel_of(name) == kernel


def _device_event(name, start, end):
    from types import SimpleNamespace

    return SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CUDA,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_aggregate_attributes_device_kernels_to_layer_spans():
    """On the card: the program's spans' device-side ranges are no
    kernels, a kernel belongs to the layer span that holds its start,
    copies are counted apart, and a kernel outside every span has no
    layer."""
    events = [
        _device_event("cet:entry", 0, 40),
        _device_event("cet:layer:conv1", 0, 10),
        _device_event("cudnn_conv", 1, 6),
        _device_event("cet:layer:res2", 12, 30),
        _device_event("sconv_pipe_kernel<ConvRows<bf16>>", 13, 20),
        _device_event("sconv_pipe_kernel<ConvRows<bf16>>", 21, 29),
        _device_event("Memcpy DtoD (Device -> Device)", 31, 33),
        _device_event("cudnn_conv", 40, 44),
    ]
    records, copy_us = opprofile.aggregate(events, cuda=True)
    assert copy_us == 2
    assert set(records) == {"cudnn_conv",
                            "sconv_pipe_kernel<ConvRows<bf16>>"}
    conv = records["cudnn_conv"]
    assert (conv["us"], conv["calls"]) == (9, 2)
    assert dict(conv["layers"]) == {"conv1": 5}
    fused = records["sconv_pipe_kernel<ConvRows<bf16>>"]
    assert (fused["us"], fused["calls"], dict(fused["layers"])) == (
        15, 2, {"res2": 15})
    assert opprofile.hand_calls(records, 1)["sconv_fused"] == 2


def test_hand_calls_count_each_kernels_instances():
    records = {"a ConvRows<x> b": {"us": 1.0, "calls": 24, "layers": {}},
               "c ConvRows<y> d": {"us": 1.0, "calls": 12, "layers": {}},
               "e DenseRows f": {"us": 1.0, "calls": 12, "layers": {}},
               "other": {"us": 5.0, "calls": 99, "layers": {}}}
    assert opprofile.hand_calls(records, 12) == {
        "sconv_fused": 3.0, "sconv_gc": 0.0, "bsc_spmm": 1.0}
    rows = opprofile.kernel_rows(records, 12, 2)
    assert [r["name"] for r in rows] == ["other", "a ConvRows<x> b"]
    assert rows[0]["share"] == 0.625 and rows[1]["kernel"] == "sconv_fused"


# ---- stability, rss_probe --------------------------------------------------

def _lines(text):
    return [json.loads(ln) for ln in text.strip().splitlines()]


def test_stability_rows_on_lenet(capsys, tmp_path, autotune_scratch):
    out = tmp_path / "stab.jsonl"
    rc = stability.main(["--platform", "cpu", "--model", "lenet",
                         "--batch", "2", "--iters", "2", "--wall-iters", "2",
                         "--zoo", "2", "--phase", "A,B,C,D", "--out",
                         str(out)])
    assert rc == 0
    printed = _lines(capsys.readouterr().out)
    written = _lines(out.read_text())
    assert [r.get("phase") for r in written[:-1]] == ["A", "B", "C", "D"]
    assert printed == written
    counts = {"A": 3, "B": 3, "C": 2, "D": 1}
    for r in written[:-1]:
        assert r["kind"] == "stability" and r["device"] == "cpu"
        assert len(r["t_sparse_ms"]) == len(r["wall_ms"]) == counts[
            r["phase"]]
        assert all(t > 0 for t in r["t_sparse_ms"] + r["wall_ms"])
    assert written[1]["zoo_modules"] == 2
    assert written[3]["t_dense_start_ms"] > 0 < written[3]["t_dense_end_ms"]
    s = written[-1]
    assert s["kind"] == "stability_summary" and s["phases"] == list("ABCD")
    assert s["spread"] >= 1 and isinstance(s["bimodal"], bool)
    assert s["spread"] == round(s["sparse_max_ms"] / s["sparse_min_ms"], 4)


@pytest.mark.parametrize("variant", rss_probe.VARIANTS)
def test_rss_probe_rows_on_lenet(variant, capsys, tmp_path):
    out = tmp_path / "rss.jsonl"
    rc = rss_probe.main(["--platform", "cpu", "--variant", variant,
                         "--model", "lenet", "--batch", "4", "--iters", "5",
                         "--every", "2", "--out", str(out)])
    assert rc == 0
    rows = _lines(capsys.readouterr().out)
    assert rows == _lines(out.read_text())
    assert [r["iter"] for r in rows] == [0, 2, 4, 5]
    assert rows[0]["rss_mb_start"] > 0
    for r in rows:
        assert r["variant"] == variant and r["model"] == "lenet"
        assert r["rss_mb"] > 0 and r["device"] == "cpu"
        assert "cuda_allocated_mb" not in r


# ---- every probe -----------------------------------------------------------

@pytest.mark.parametrize("name", PROBES)
def test_probe_without_a_card_exits_2(name, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"caffe_escoin_tpu_torch.experiments.{name}")
    assert mod.main(["--platform", "cuda", "--out",
                     str(tmp_path / "x.jsonl")]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert not (tmp_path / "x.jsonl").exists()


@pytest.mark.parametrize("name", PROBES)
def test_probe_default_output_is_under_build(name):
    mod = importlib.import_module(f"caffe_escoin_tpu_torch.experiments.{name}")
    ap = common.parser(name, mod.__doc__)
    assert Path(ap.parse_args([]).out) == (
        ROOT / "build" / "experiments" / f"{name}.jsonl")


@pytest.mark.parametrize("path", ["caffe_escoin_tpu/x.jsonl",
                                  "scripts/x.jsonl", "logs/exp_k3_r5.jsonl"])
def test_rows_refuse_the_jax_packages_paths(path):
    with pytest.raises(ValueError, match="JAX package"):
        common.Rows(str(ROOT / path), CPU)
