"""The element-wise configuration (``resnet50-elem90``) and the harness's
policy, on the CPU:

* ``port_policy`` converts ``sparse_format`` by member name, as it does
  ``conv_mode``, and refuses a name that is no member (or a value that is
  no name) with its key; the four block configurations' policies come
  out as they did before it converted more than ``conv_mode``;
* the element-wise rule keeps about a tenth (ties at the threshold cut)
  of every pruned layer's weights, and leaves conv1 dense;
* whole runs of the tiny cell through the program's ELL route at
  224x224, 2 images a query: a sound run is correct and every pruned conv
  routes ``ell``; the control (the reference in float8 in the program's
  place) is not correct, nor is a run whose timed path alters an answer
  where the classifier makes it or walks half of each ELL row; a program
  given the block format where the configuration names ELL fails set-up,
  naming a conv.

On the card (``-m cuda``): the cell at 224x224, three seeds, correct.
"""

import dataclasses
import json
import sys

import pytest
import torch

from portbench import harness, program_trace, system, weights
from portbench.reference import resnet50
from portbench.system import ReferenceSystem
from portbench.tests.conftest import ROOT

CPU = torch.device("cpu")
SEED = 2 ** 31 + 37
CELL = "resnet50-elem90.tiny"
CONFIG = json.loads(
    (ROOT / "portbench" / "configs" / "resnet50-elem90.json").read_text())
BLOCK_POLICY = {"conv_mode": "SCONV_PAR", "block_shape": [128, 128],
                "compute_dtype": "bfloat16", "cast_back": False,
                "use_xla_sparse": False}


@pytest.fixture(autouse=True)
def program_aggregates_cleared():
    yield
    trace = sys.modules.get(program_trace.TRACE_MODULE)
    if trace is not None:
        trace.reset()


def _context():
    from caffe_escoin_tpu_torch.engine import context

    return context


def _run(root, seed=SEED, **kw):
    return harness.run_cell(harness.Bench(root), CELL, seed, 0.1, False, CPU,
                            clock=lambda: 1.0, **kw)


def test_sparse_format_converted_by_name():
    ctx = _context()
    p = system.port_policy(CONFIG["policy"])
    assert p.sparse_format is ctx.SparseFormat.ELL
    assert p.conv_mode is ctx.ConvMode.LOWERED_SPARSE
    assert p.compute_dtype is torch.bfloat16
    assert p.block_shape == (128, 128)
    assert system.port_policy(dict(BLOCK_POLICY, sparse_format="BSR")
                              ).sparse_format is ctx.SparseFormat.BSR


@pytest.mark.parametrize("key, value", [
    ("sparse_format", "CSC"), ("sparse_format", "ell"),
    ("sparse_format", 1), ("conv_mode", "SCONV_FAST"),
    ("compute_dtype", "bfloat17"), ("compute_dtype", "float8_e4m3fn_x"),
    ("compute_dtype", "nn")])
def test_unknown_name_fails_with_its_key(key, value):
    with pytest.raises(ValueError, match=f"policy {key}"):
        system.port_policy(dict(CONFIG["policy"], **{key: value}))


@pytest.mark.parametrize("config, changed", [
    ("resnet50-block90", {}), ("googlenet-block90", {}),
    ("alexnet-block90", {}),
    ("vgg16-block90-autotuned",
     {"use_xla_sparse": True, "autotune": True, "autotune_cache": ""})])
def test_block_policies_as_before(config, changed):
    """Each block configuration's policy, field by field, as the parent's
    ``port_policy`` built it (only ``conv_mode``, ``block_shape`` and
    ``compute_dtype`` converted, every other field as written)."""
    ctx = _context()
    cfg = json.loads(
        (ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    assert "sparse_format" not in cfg["policy"]
    want = ctx.ExecutionPolicy(conv_mode=ctx.ConvMode.SCONV_PAR,
                               block_shape=(128, 128),
                               compute_dtype=torch.bfloat16, cast_back=False,
                               use_xla_sparse=False)
    want = dataclasses.replace(want, **changed)
    got = system.port_policy(cfg["policy"])
    assert got == want
    assert got.sparse_format is ctx.SparseFormat.BSR


def test_elementwise_rule_keeps_a_tenth():
    """Kept share of every pruned layer in (0.095, 0.1 + 1/n]: ranked by
    |w|, the ties at the threshold cut too; conv1 (3 channels) dense;
    52 convs and fc1000 pruned."""
    table, params, pruned = weights.make_net(CONFIG, resnet50, SEED, CPU)
    convs = [e["name"] for e in table if e["type"] == "conv"]
    assert pruned == convs[1:] + ["fc1000"] and len(pruned) == 53
    assert bool((params["conv1"]["w"] != 0).all())
    total = kept = 0
    for name in pruned:
        w = params[name]["w"]
        n, k = w.numel(), int((w != 0).sum())
        assert 0.095 < k / n <= 0.1 + 1 / n, (name, k / n)
        total, kept = total + n, kept + k
    assert 0.098 < kept / total <= 0.1


def test_tiny_cell_runs_ell_and_is_correct(bench_root, capfd):
    r = _run(bench_root)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert "routes: dense 2, ell 52\n" in capfd.readouterr().err
    c = _run(bench_root, make_system=lambda cfg, t, p, d:
             ReferenceSystem(cfg, t, p, d, "float8_e4m3fn"))
    assert not c["correct"], c["checks"]


def test_guard_fails_a_block_policy(bench_root, monkeypatch):
    """The program handed the block format (as the harness once handed it
    the string ``"ELL"``, which no member equals) routes the pruned convs
    ``lowered``: set-up fails naming the first."""
    ctx = _context()
    built = system.port_policy
    monkeypatch.setattr(system, "port_policy", lambda policy: dataclasses
                        .replace(built(policy),
                                 sparse_format=ctx.SparseFormat.BSR))
    with pytest.raises(RuntimeError, match="res2a_branch1: .* 'lowered'"):
        _run(bench_root)


def _alter_answer(monkeypatch):
    """One image's logits permuted where the program's classifier makes
    them."""
    from caffe_escoin_tpu_torch.nn.layers import InnerProductLayer

    forward = InnerProductLayer.forward

    def altered(self, params, inputs, state=None):
        (out,) = forward(self, params, inputs, state)
        out = out.clone()
        out[0] = out[0].roll(1)
        return [out]

    monkeypatch.setattr(InnerProductLayer, "forward", altered)


def _drop_half_the_slots(monkeypatch):
    """The ELL SpMM that the pruned convs run walks only the first half of
    each row's slots."""
    from caffe_escoin_tpu_torch.kernels import spmm

    full = spmm.ell_spmm

    def half(ell, b):
        w = max(1, ell.width // 2)
        return full(dataclasses.replace(ell, values=ell.values[:, :w],
                                        colidx=ell.colidx[:, :w]), b)

    monkeypatch.setattr(spmm, "ell_spmm", half)


@pytest.mark.parametrize("fault", [_alter_answer, _drop_half_the_slots],
                         ids=["altered_answer", "half_the_slots"])
def test_broken_timed_path_is_not_correct(bench_root, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(bench_root)
    assert not r["correct"] and r["failed"] > 0, r["checks"]


@pytest.mark.cuda
def test_cell_on_the_card(card, bench_root):
    """The cell's configuration at 224x224, 2 images a query, three seeds:
    correct on the card, the control not."""
    control = (lambda cfg, t, p, d:
               ReferenceSystem(cfg, t, p, d, "float8_e4m3fn"))
    for seed in (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303):
        r = harness.run_cell(harness.Bench(bench_root), CELL, seed, 0.5,
                             False, card, clock=lambda: 0.0)
        assert r["correct"], (seed, r["checks"])
        assert r["device"]["platform"] == "gpu"
        c = harness.run_cell(harness.Bench(bench_root), CELL, seed, 0.5,
                             False, card, clock=lambda: 0.0,
                             make_system=control)
        assert not c["correct"], (seed, c["checks"])
