"""On the card, at the configurations' own widths and image size (2
images a query, so that a test run holds it): a sound run of the program
is correct, the control (the reference in float8 in the program's place)
is not, and an answer altered where the program's classifier makes it is
not. ``python -m pytest -m cuda portbench/tests`` on the card."""

import pytest

from portbench import harness
from portbench.system import ReferenceSystem

pytestmark = pytest.mark.cuda
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card_root(card, tmp_path):
    import json

    from portbench.tests.conftest import make_small_root

    root = make_small_root(tmp_path)
    for cfg_file in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(cfg_file.read_text())
        cfg["input_hwc"] = [224, 224, 3]
        cfg_file.write_text(json.dumps(cfg))
    return root


def run(root, device, cell, seed, **kw):
    return harness.run_cell(harness.Bench(root), cell, seed, 0.5, False,
                            device, clock=lambda: 0.0, **kw)


@pytest.mark.parametrize("cell", ["resnet50-block90.tiny",
                                  "googlenet-block90.tiny"])
def test_program_correct_control_not(card, card_root, cell):
    control = (lambda cfg, t, p, d:
               ReferenceSystem(cfg, t, p, d, "float8_e4m3fn"))
    for seed in SEEDS:
        r = run(card_root, card, cell, seed)
        assert r["correct"], (seed, r["checks"])
        assert r["device"]["platform"] == "gpu"
        c = run(card_root, card, cell, seed, make_system=control)
        assert not c["correct"], (seed, c["checks"])


def test_altered_answer_not_correct(card, card_root, monkeypatch):
    from caffe_escoin_tpu_torch.nn.layers import InnerProductLayer

    forward = InnerProductLayer.forward

    def altered(self, params, inputs, state=None):
        (out,) = forward(self, params, inputs, state)
        out = out.clone()
        out[0] = out[0].roll(1)
        return [out]

    monkeypatch.setattr(InnerProductLayer, "forward", altered)
    r = run(card_root, card, "resnet50-block90.tiny", SEEDS[0])
    assert not r["correct"] and r["failed"] > 0, r["checks"]
