"""The port's measuring program (caffe_escoin_tpu_torch/bench.py) against
the repository's ``bench.py``, on the CPU.

The JAX program does not run whole on the CPU (its e2e dense arms hand the
params dict to a timer that times its first argument), and its times are
only the device's, so parity is held at the level of the functions it
calls, on the same numpy inputs; ``bench.py`` is loaded by path (it imports
jax only inside its functions):

* the conv configs and the fc selection of each model;
* the roofline bound for one stream rate;
* the per-layer cases at ``--smoke --batch 1`` on ResNet-50: the inputs
  and weights bit-equal to ``bench.py``'s draw order, the JAX
  ``weight_align``'s nnz and live blocks, and the sparse conv within
  1e-2 * max|ref| + 1e-2 of the JAX ``conv2d_sconv`` on the same bf16
  input;
* the e2e preparation from JAX params (a narrow ResNet with non-trivial
  BatchNorm statistics), against ``bench.py``'s steps written out here:
  the same layers pruned, the same zero blocks, and the sparse logits
  within 5e-2 relative L2;
* each mode's line: ``bench.py``'s keys for that mode plus ``device``;
* ``--platform auto`` without a card exits 2, ``--weights-as-args``
  raises, ``--halo`` writes under build/, and ``device_time_cycle`` on the
  CPU.
"""

import hashlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode as JConvMode  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy as JPolicy  # noqa: E402
from caffe_escoin_tpu.models import ZOO as JZOO  # noqa: E402
from caffe_escoin_tpu.models import resnet as jresnet  # noqa: E402
from caffe_escoin_tpu.nn import LayerSpec as JLayerSpec  # noqa: E402
from caffe_escoin_tpu.nn import Net as JNet  # noqa: E402
from caffe_escoin_tpu.nn.fuse import fuse_inference as jfuse  # noqa: E402
from caffe_escoin_tpu.ops import conv as jconv  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align as jweight_align  # noqa: E402
from caffe_escoin_tpu.utils import pruning as jpruning  # noqa: E402

from caffe_escoin_tpu_torch import bench  # noqa: E402
from caffe_escoin_tpu_torch.engine import autotune  # noqa: E402
from caffe_escoin_tpu_torch.models import resnet  # noqa: E402
from caffe_escoin_tpu_torch.nn import LayerSpec, params_from_jax  # noqa: E402
from caffe_escoin_tpu_torch.ops import conv as conv_ops  # noqa: E402
from caffe_escoin_tpu_torch.utils.benchmark import device_time_cycle  # noqa: E402

from test_torch_net import _narrow_resnet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PARITY_REL, PARITY_ABS = 1e-2, 1e-2
LOGITS_REL_L2 = 5e-2

# the keys of each mode's line in bench.py (run_e2e :585-613, run_per_layer
# :268-277, run_fc :381-389, run_halo :763-766, run_batch_curve :840-845),
# plus the port's "device"
E2E_KEYS = {"metric", "value", "unit", "batch", "vs_baseline",
            "speedup_vs_dense_f32", "t_dense_f32_ms", "t_dense_bf16_ms",
            "t_sparse_ms", "fused", "autotune", "packed", "s2d",
            "weights_as_args"}
MODE_KEYS = {
    "e2e": E2E_KEYS,
    "e2e_calibrated": E2E_KEYS | {"calibrated", "calibration", "buckets"},
    "per_layer": {"metric", "value", "unit", "batch", "vs_baseline",
                  "speedup_vs_dense_f32", "gnnz_per_s", "autotune"},
    "fc": {"metric", "value", "unit", "batch", "vs_baseline",
           "speedup_vs_dense_f32"},
    "halo": {"metric", "value", "unit", "vs_baseline", "rows"},
    "batch_curve": {"metric", "value", "unit", "vs_baseline", "rows"},
}
# tiny runs of each mode on the CPU
MODE_ARGV = {
    "e2e": ["--e2e", "--model", "lenet", "--batch", "2"],
    "e2e_calibrated": ["--e2e", "--model", "lenet", "--batch", "2",
                       "--buckets", "--calibrate", "--calibrate-polish", "2"],
    "per_layer": ["--per-layer", "--smoke", "--batch", "1"],
    "fc": ["--fc", "--model", "lenet", "--batch", "2"],
    "halo": ["--halo", "--batch", "1"],
    "batch_curve": ["--batch-curve", "--model", "lenet"],
}


def _load_jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load_jax_bench()


@pytest.fixture
def shapes_only_jax_init(monkeypatch):
    """The JAX ``Net.init`` traced under ``jax.eval_shape``: it still walks
    and records every blob's shape, which is all conv_configs and the fc
    rule read, without drawing the weights."""
    orig = JNet.init
    monkeypatch.setattr(JNet, "init", lambda self, key, shapes: jax.eval_shape(
        lambda k: orig(self, k, shapes), key))


@pytest.fixture
def autotune_scratch(tmp_path, monkeypatch):
    """A run's autotune table in tmp_path, the process's table emptied
    after it."""
    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("CESCOIN_AUTOTUNE_LOG_HITS", "")
    yield
    autotune.clear()


@pytest.mark.parametrize("model", ["resnet50", "googlenet", "alexnet",
                                   "lenet"])
def test_conv_configs_are_the_jax_configs(model, shapes_only_jax_init):
    assert bench.conv_configs(model, 1) == jbench.conv_configs(model, 1)


@pytest.mark.parametrize("model", ["lenet", "alexnet"])
def test_fc_selection_is_the_jax_rule(model, shapes_only_jax_init):
    """bench.py's run_fc rule (:304-312) on the JAX net's shapes."""
    builder, input_shapes = JZOO[model]
    net = JNet(builder())
    net.init(jax.random.PRNGKey(0), {"data": (1,) + tuple(
        input_shapes["data"][1:])})
    want = []
    for layer in net.layers:
        if layer.spec.type != "InnerProduct":
            continue
        k = int(np.prod(net.blob_shapes[layer.spec.bottoms[0]][1:]))
        m = layer.p["num_output"]
        if m < 128 or k < 256:
            continue
        want.append((layer.spec.name, k, m))
    assert want
    assert bench.fc_configs(model, 1) == want


def test_roofline_is_the_jax_bound(monkeypatch):
    rate = 2.9e12
    monkeypatch.setattr(bench, "_STREAM_RATE", rate)
    monkeypatch.setattr(jbench, "_STREAM_RATE", rate)
    for args in [(32, 56, 56, 64, 56, 56, 64, 3, 64, 64),
                 (1, 14, 14, 256, 14, 14, 256, 4, 128, 128, 4)]:
        assert bench.roofline_us(*args) == jbench.roofline_us(*args)


def test_per_layer_cases_are_the_jax_draws_and_convs(shapes_only_jax_init):
    args = bench.parse_args(["--per-layer", "--smoke", "--batch", "1",
                             "--no-autotune", "--platform", "cpu"])
    items, _ = bench.per_layer_items(args)
    # bench.py's selection and draw order, written out (:119-168)
    configs = jbench.conv_configs("resnet50", 1)
    eligible = {k: c for k, c in configs.items() if k[5] == 1 and k[2] >= 64}

    def flops_of(key, count):
        h, w, cin, cout, k, s_, p_, g_ = key
        return count * 2 * h * w * cin * cout * k * k / (s_ * s_) / g_

    jitems = sorted(eligible.items(), key=lambda kv: -flops_of(*kv))[:2]
    assert items == jitems
    rng = np.random.default_rng(0)
    jpol = JPolicy(block_shape=(128, 128), compute_dtype=jnp.bfloat16,
                   cast_back=False)
    pol = bench._sparse_policy(args, autotune=False)
    got = []
    for (key, count), case in zip(jitems, bench.per_layer_cases(args,
                                                                items)):
        h, w, cin, cout, k, s, p, g = key
        xs = [rng.standard_normal((1, h, w, cin)).astype(np.float32) * 0.1
              for _ in range(4)]
        wt = rng.standard_normal((k, k, cin // g, cout)).astype(
            np.float32) * 0.05
        wp = jpruning.prune_conv_weight(wt, 0.9, (128, 128))
        pkey, pcount, pxs, pwp, aligned = case
        assert (pkey, pcount) == (key, count)
        assert all(np.array_equal(a, b) for a, b in zip(pxs, xs))
        assert np.array_equal(pwp, wp)
        jal = jweight_align(jnp.asarray(wp), None, groups=g, policy=jpol)
        live = int(aligned.bsc.pattern()[1].sum())
        assert aligned.stats.nnz == jal.stats.nnz
        assert live == int(np.asarray(jal.bsc.bcol_nnz).sum())
        got.append((aligned.stats.nnz, live))
        xb = jnp.asarray(xs[0]).astype(jnp.bfloat16)
        ref = np.asarray(jconv.conv2d_sconv(
            xb, jal, stride=(s, s), padding=(p, p), dilation=(1, 1),
            relu=False, policy=jpol, batch_parallel=True).astype(
                jnp.float32))
        out = conv_ops.conv2d_sconv(
            torch.from_numpy(xs[0]).bfloat16(),
            aligned.to(CPU, torch.bfloat16), stride=(s, s), padding=(p, p),
            dilation=(1, 1), relu=False, policy=pol, batch_parallel=True)
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= PARITY_REL * np.abs(ref).max() + PARITY_ABS, err
    # the nnz and live blocks of the JAX run at this size
    assert [n for n, _ in got] == [65536, 16384], got


def _bn_state_and_affine(jnet, jparams):
    """Non-trivial BatchNorm statistics and Scale affine, so the fold does
    real work (init leaves count 0, gamma 1, beta 0)."""
    rng = np.random.default_rng(0)
    state = {}
    for name, st in jnet.state0.items():
        c = st["mean_acc"].shape[0]
        state[name] = {
            "mean_acc": rng.standard_normal(c).astype(np.float32) * 0.2,
            "var_acc": rng.uniform(1.0, 3.0, c).astype(np.float32),
            "count": np.float32(2.0)}
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jparams.items()}
    for s in jnet.specs:
        if s.type == "Scale":
            c = params[s.name]["gamma"].shape[0]
            params[s.name]["gamma"] = rng.uniform(0.5, 1.5, c).astype(
                np.float32)
            params[s.name]["beta"] = rng.standard_normal(c).astype(
                np.float32) * 0.1
    return params, state


def test_e2e_preparation_is_the_jax_steps(autotune_scratch):
    """bench.py's e2e steps (:412-494) on the JAX side, the port's
    prepare_e2e from the same params on the other, SCONV_PAR in bf16."""
    shapes = {"data": (2, 32, 32, 3)}
    args = bench.parse_args(["--e2e", "--model", "resnet50", "--no-autotune",
                             "--platform", "cpu"])
    jspecs = _narrow_resnet(jresnet._conv_bn, jresnet._bottleneck,
                            JLayerSpec)
    jpol_s = JPolicy(conv_mode=JConvMode.SCONV_PAR, block_shape=(128, 128),
                     compute_dtype=jnp.bfloat16, cast_back=False)
    jnet_d = JNet(jspecs, policy=JPolicy(), phase="test")
    jnet_s = JNet(jspecs, policy=jpol_s, phase="test")
    params, state = _bn_state_and_affine(
        jnet_d, jnet_d.init(jax.random.PRNGKey(0), shapes))
    jpruned, jnames = dict(params), []
    for layer in jnet_s.layers:
        n = layer.spec.name
        if n not in jpruned:
            continue
        q = dict(jpruned[n])
        if layer.spec.type in ("Convolution", "ConvolutionReLU"):
            w = np.asarray(q["w"])
            if w.shape[0] * w.shape[1] * w.shape[2] < 32:
                continue
            q["w"] = jnp.asarray(jpruning.prune_conv_weight(w, 0.9,
                                                            (128, 128)))
        elif layer.spec.type == "InnerProduct":
            q["w"] = jnp.asarray(jpruning.prune_blocks(np.asarray(q["w"]),
                                                       0.9, (128, 128)))
        else:
            continue
        jpruned[n] = q
        jnames.append(n)
    jnet_d, _ = jfuse(jnet_d, params, state=state)
    jnet_s.blob_shapes = dict(jnet_d.blob_shapes)
    jnet_s, jpruned_s = jfuse(jnet_s, jpruned, state=state)
    jaligned = jnet_s.weight_align(jpruned_s)

    tparams, tstate = params_from_jax(params, state)
    e = bench.prepare_e2e(
        args, CPU, specs=_narrow_resnet(resnet._conv_bn, resnet._bottleneck,
                                        LayerSpec),
        shapes=shapes, params=tparams, state=tstate)
    assert e.pruned_names == jnames
    for n in jnames:
        assert np.array_equal(e.pruned[n]["w"].numpy() == 0,
                              np.asarray(jpruned[n]["w"]) == 0), n
    sparse = [n for n, a in jaligned.items()
              if getattr(a, "bsc", None) is not None]
    assert sparse and sorted(sparse) == sorted(
        n for n, a in e.aligned.items() if getattr(a, "bsc", None)
        is not None)
    for n in sparse:
        block_row, bcol_nnz = e.aligned[n].bsc.pattern()
        assert np.array_equal(bcol_nnz, np.asarray(jaligned[n].bsc.bcol_nnz))
        for j, live in enumerate(bcol_nnz):
            assert np.array_equal(
                block_row[j, :live],
                np.asarray(jaligned[n].bsc.block_row)[j, :live]), n

    # the features before the classifier within the logits' limit; the
    # classifier itself is one 128x128 block, which prune_blocks removes
    # at 90% on both sides (as bench.py prunes it), so its logits are 0
    x = e.xs[0]
    jblobs = jnet_s.apply(jaligned, {"data": jnp.asarray(x.numpy())},
                          return_blobs=True)
    blobs = e.net_s.inference_fn(e.aligned, return_blobs=True)({"data": x})
    ref = np.asarray(jblobs["pool5"], np.float64)
    got = blobs["pool5"].double().numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= LOGITS_REL_L2, rel
    assert not np.asarray(jblobs["fc"]).any() and not blobs["fc"].any()


@pytest.mark.parametrize("mode", list(MODE_ARGV))
def test_each_mode_prints_the_jax_keys(mode, capsys, monkeypatch, tmp_path,
                                       autotune_scratch):
    """One JSON line, the last of stdout, with bench.py's keys for the mode
    and the device; --halo with an empty --jsonl appends to build/, never
    to the JAX package's SCALING.jsonl."""
    record = ROOT / "SCALING.jsonl"
    before = hashlib.sha256(record.read_bytes()).hexdigest()
    monkeypatch.setattr(bench, "HALO_RECORD",
                        str(tmp_path / "build" / "SCALING.jsonl"))
    rows = tmp_path / "rows.jsonl"
    jsonl = [] if mode == "halo" else ["--jsonl", str(rows)]
    rc = bench.main(MODE_ARGV[mode] + ["--repeats", "1", "--platform", "cpu"]
                    + jsonl)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == MODE_KEYS[mode] | {"device"}
    assert line["device"] == "cpu"
    assert line["value"] > 0
    if mode == "halo":
        written = (tmp_path / "build" / "SCALING.jsonl").read_text()
        assert json.loads(written.splitlines()[-1]) == line
        assert len(written.splitlines()) == line["rows"] + 1
        assert hashlib.sha256(record.read_bytes()).hexdigest() == before
    elif mode == "batch_curve":  # bench.py appends the rows alone
        curve = [json.loads(r) for r in rows.read_text().splitlines()]
        assert [[r["batch"], r["images_per_s"]] for r in curve] == \
            line["rows"]
    else:
        assert json.loads(rows.read_text().splitlines()[-1]) == line
    if mode == "per_layer":
        layer_rows = [json.loads(r) for r in rows.read_text().splitlines()]
        assert all(r["stream_rate_tb_s"] > 0 for r in layer_rows[:-1])
    if mode == "e2e_calibrated":
        assert line["calibrated"] and line["calibration"]["polish_trials"] == 2


def test_halo_record_is_under_build():
    assert Path(bench.HALO_RECORD) == ROOT / "build" / "SCALING.jsonl"


def test_bare_invocation_is_the_headline_run():
    args = bench.parse_args([])
    assert (args.e2e, args.buckets, args.batch, args.repeats, args.calibrate,
            args.calibrate_polish, args.model, args.autotune) == (
        True, True, 32, 20, True, 8, "resnet50", True)
    assert (args.pack, args.s2d, args.platform) == (False, False, "auto")
    assert not bench.parse_args(["--no-autotune"]).calibrate


def test_platform_auto_without_cuda_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--per-layer", "--smoke", "--platform", "auto"]) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""


def test_weights_as_args_raises():
    with pytest.raises(NotImplementedError):
        bench.main(["--e2e", "--weights-as-args", "--platform", "cpu"])


def test_device_time_cycle_on_cpu_calls_its_pairs_in_turn():
    calls = []

    def pair(i):
        w = torch.ones((16, 16)) * i
        return lambda y: calls.append(i) or y @ w

    xs = [torch.ones((16, 16)) * i for i in range(3)]
    t = device_time_cycle([(pair(i), (x,)) for i, x in enumerate(xs)],
                          iters=5)
    assert t > 0
    assert calls == [0, 1, 2] + [0, 1, 2, 0, 1]
