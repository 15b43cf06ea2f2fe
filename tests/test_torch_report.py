"""The port's measurement suite and table renderers
(caffe_escoin_tpu_torch/tools/{report,sweep_table,suite}.py) against
``scripts/report.py``, ``scripts/sweep_table.py`` and the shell scripts
that ran the reference's suite, on the CPU.

* Parity: the reference's own records (``BENCH_SWEEP.jsonl``, 257 rows,
  and ``SCALING.jsonl``, 42), read-only, each row tagged with a card's
  device label, through the reference's renderers (loaded by path: they
  import json and sys only) and the port's. Every table is equal line for
  line once the port's device headings are taken out; with two labels
  the port renders one section per label, each the reference's table of
  that label's rows.
* Refusals: a row without a device label, or with "cpu", names its file
  and line; the JAX package's records and ``docs/BENCH_TABLES.md`` raise
  as input or output, and stay unchanged.
* The suite's list equals the ``bench.py`` lines of
  ``scripts/run_chip_suite.sh:17-41`` (loops expanded) and
  ``scripts/run_chip_r5i.sh:7-12,18``, translated to the port's module
  and record; a run whose entry fails exits 1, names it and still runs the
  entries after it.
* The renderer on the port's own rows: a ``--per-layer --smoke`` and a
  ``--batch-curve`` CPU run of the bench, labelled as a card here.
* The committed capture (``docs/cuda/``): every row an NVIDIA card's, and
  the module's output on it equal to the committed tables byte for byte.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

from caffe_escoin_tpu_torch import bench
from caffe_escoin_tpu_torch.engine import autotune
from caffe_escoin_tpu_torch.tools import report, suite, sweep_table

ROOT = Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
CARD_B = "NVIDIA H100 80GB HBM3, 500.00 W"
SWEEP_TABLES = ("headline_table", "conv_bucket_table", "fc_table",
                "batch_curve", "per_layer_tables")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_report = _load_script("report")
ref_sweep_table = _load_script("sweep_table")


def _reference_rows(name):
    rows = [json.loads(line) for line in
            (ROOT / name).read_text().splitlines() if line.strip()]
    assert len(rows) == {"BENCH_SWEEP.jsonl": 257, "SCALING.jsonl": 42}[name]
    return rows


def _tagged(rows, labels):
    """Copies of ``rows``, row i labelled ``labels[i % len(labels)]``."""
    return [dict(r, device=labels[i % len(labels)])
            for i, r in enumerate(rows)]


def _without_headings(lines, labels):
    """The port's lines with the device in every ``## `` title taken out."""
    pat = re.compile("(" + "|".join(re.escape(report.HEADING_SEP + lb)
                                    for lb in labels) + ")$")
    return [pat.sub("", line) if line.startswith("## ") else line
            for line in lines]


def _joined(blocks):
    """The reference's blocks of each label, as the port joins them."""
    out = []
    for block in blocks:
        if out and block and block[0]:
            out.append("")
        out += block
    return out


def _case(name, labels):
    """The rows of table ``name`` tagged with ``labels``, and the
    reference's block of each label's rows."""
    rows = _tagged(_reference_rows(
        "SCALING.jsonl" if name == "halo_table" else "BENCH_SWEEP.jsonl"),
        labels)
    blocks = {lb: getattr(ref_report, name)(
        [r for r in rows if r["device"] == lb]) for lb in labels}
    return rows, blocks


@pytest.mark.parametrize("labels", [(CARD,), (CARD, CARD_B)],
                         ids=["one_card", "two_cards"])
@pytest.mark.parametrize("name", SWEEP_TABLES + ("halo_table",))
def test_each_table_is_the_reference_table(name, labels):
    rows, blocks = _case(name, labels)
    got = getattr(report, name)(rows)
    want = _joined(blocks.values())
    assert any(line.startswith("|") for line in want)
    assert _without_headings(got, labels) == want
    # every section headed by its card, the sections of one card together;
    # two cards give two sections (the one fc headline goes to one card)
    titles = [line for line in got if line.startswith("## ")]
    cards = [lb for t in titles for lb in labels
             if t.endswith(report.HEADING_SEP + lb)]
    assert len(cards) == len(titles)
    assert list(dict.fromkeys(cards)) == [lb for lb in labels if blocks[lb]]
    assert len(set(cards)) == (1 if name == "fc_table" else len(labels))
    assert cards == sorted(cards, key=labels.index)


def test_render_is_the_reference_document(capsys, tmp_path, monkeypatch):
    """The whole document, but its first three lines (title and source
    note), against ``scripts/report.py``'s ``main`` run on the same rows."""
    sweep = _tagged(_reference_rows("BENCH_SWEEP.jsonl"), (CARD,))
    scaling = _tagged(_reference_rows("SCALING.jsonl"), (CARD,))
    for name, rows in (("BENCH_SWEEP.jsonl", sweep),
                       ("SCALING.jsonl", scaling)):
        (tmp_path / name).write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
    monkeypatch.chdir(tmp_path)
    ref_report.main([])
    want = capsys.readouterr().out.split("\n")
    got = report.render(sweep, scaling).split("\n")
    assert _without_headings(got[3:], (CARD,)) == want[3:-1]


@pytest.mark.parametrize("labels", [(CARD,), (CARD, CARD_B)],
                         ids=["one_card", "two_cards"])
def test_sweep_table_is_the_reference_table(labels, tmp_path, capsys):
    rows = _tagged(_reference_rows("BENCH_SWEEP.jsonl"), labels)
    want = []
    for lb in labels:
        path = tmp_path / f"rows_{len(want)}.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in rows
                                if r["device"] == lb))
        ref_sweep_table.main(str(path))
        block = capsys.readouterr().out.splitlines()
        want += ([""] if want else []) + [f"### {lb}", ""] + block
    record = tmp_path / "port.jsonl"
    record.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert sweep_table.main([str(record)]) == 0
    assert capsys.readouterr().out.splitlines() == want


@pytest.mark.parametrize("device", [None, "cpu", ""])
def test_a_row_without_a_card_is_refused(device, tmp_path):
    rows = [dict(metric="m", value=1.0, device=CARD), dict(metric="m",
                                                           value=2.0)]
    if device is not None:
        rows[1]["device"] = device
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    with pytest.raises(report.RefusedRow, match=re.escape(f"{path}:2")):
        report.load(path)
    with pytest.raises(report.RefusedRow):
        sweep_table.main([str(path)])
    with pytest.raises(report.RefusedRow):
        report.headline_table(rows)


@pytest.mark.parametrize("call", [
    lambda: report.load(ROOT / "BENCH_SWEEP.jsonl"),
    lambda: report.load(ROOT / "SCALING.jsonl"),
    lambda: report.main(["--dir", str(ROOT)]),
    lambda: report.write("x", ROOT / "docs" / "BENCH_TABLES.md"),
    lambda: report.main(["--dir", str(ROOT / "docs"), "--write"]),
    lambda: sweep_table.main([str(ROOT / "BENCH_SWEEP.jsonl")]),
], ids=["sweep", "scaling", "report_root", "jax_tables", "write_docs",
        "sweep_table"])
def test_the_jax_records_are_refused(call):
    paths = [ROOT / "BENCH_SWEEP.jsonl", ROOT / "SCALING.jsonl",
             ROOT / "docs" / "BENCH_TABLES.md"]
    before = [hashlib.sha256(p.read_bytes()).hexdigest() for p in paths]
    with pytest.raises(ValueError, match="JAX package's record"):
        call()
    assert [hashlib.sha256(p.read_bytes()).hexdigest()
            for p in paths] == before


def _shell_commands(path, first, last):
    """The bench and pytest lines of a shell script's lines first..last
    (1-based), continuations joined, ``for V in ...; do ...; done`` loops
    expanded, as argv lists without the ``run``/``timeout N`` prefix, the
    environment assignments and the redirections."""
    text = "\n".join((ROOT / "scripts" / path).read_text().splitlines()
                     [first - 1:last]).replace("\\\n", " ")
    loop = None
    cmds = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "echo")):
            continue
        m = re.match(r"for (\w+) in ([^;]*); do(.*?)(; done)?$", line)
        if m:
            loop = (m.group(1), m.group(2).split())
            line = m.group(3).strip()
            if not line:
                continue
        if line == "done":
            loop = None
            continue
        bodies = ([line.replace(f"${loop[0]}", v) for v in loop[1]]
                  if loop else [line])
        if m and m.group(4):
            loop = None
        for body in bodies:
            argv = shlex.split(body)
            argv = argv[:argv.index(">>")] if ">>" in argv else argv
            while argv[0] in ("run", "timeout") or "=" in argv[0] \
                    or argv[0].isdigit():
                argv = argv[1:]
            cmds.append(argv)
    return cmds


def _translated(argv, out):
    """A reference line as the port's suite runs it."""
    if argv[:3] == ["python", "-m", "pytest"]:
        assert argv[3:] == ["tests", "-m", "tpu", "-q"]
        return suite.CARD_TESTS
    assert argv[:2] == ["python", "bench.py"], argv
    records = {"$J": "BENCH_SWEEP.jsonl", "BENCH_SWEEP.jsonl":
               "BENCH_SWEEP.jsonl", "SCALING.jsonl": "SCALING.jsonl"}
    return suite.BENCH + [str(out / records[a]) if a in records else a
                          for a in argv[2:]]


def test_the_suite_is_the_reference_scripts(tmp_path):
    ref = (_shell_commands("run_chip_suite.sh", 17, 41)
           + _shell_commands("run_chip_r5i.sh", 7, 12)
           + _shell_commands("run_chip_r5i.sh", 18, 18))
    assert len(ref) == 21
    assert ref[-1] == ["python", "bench.py", "--halo", "--jsonl",
                       "SCALING.jsonl"]
    assert suite.commands(tmp_path) == [_translated(a, tmp_path)
                                        for a in ref]
    # every bench entry appends to the capture's record, --halo to its
    # SCALING.jsonl
    for cmd in suite.commands(tmp_path):
        if cmd[:3] == suite.BENCH:
            want = "SCALING.jsonl" if "--halo" in cmd else "BENCH_SWEEP.jsonl"
            assert cmd[-2:] == ["--jsonl", str(tmp_path / want)]


def _stubs(tmp_path, failing):
    """Entries that write their index to a marker file, entry ``failing``
    exiting 3 after it."""
    marks = tmp_path / "ran"

    def cmds(out):
        return [["python", "-c",
                 f"open({str(marks)!r}, 'a').write('{i} ');"
                 f"raise SystemExit({3 if i == failing else 0})"]
                for i in range(3)]
    return cmds, marks


def test_the_suite_runs_on_past_a_failure_and_exits_1(tmp_path, monkeypatch,
                                                     capsys):
    cmds, marks = _stubs(tmp_path, failing=1)
    monkeypatch.setattr(suite, "commands", cmds)
    assert suite.main(["--out", str(tmp_path / "out")]) == 1
    err = capsys.readouterr().err
    assert marks.read_text().split() == ["0", "1", "2"]
    assert "=== entry 1: rc 3" in err
    failed = [line for line in err.splitlines() if line.startswith("FAILED")]
    assert len(failed) == 1 and failed[0].startswith("FAILED entry 1 (rc 3)")
    assert "=== python -c" in err


def test_the_suite_exits_0_when_every_entry_passes(tmp_path, monkeypatch,
                                                   capsys):
    cmds, marks = _stubs(tmp_path, failing=None)
    monkeypatch.setattr(suite, "commands", cmds)
    assert suite.main(["--out", str(tmp_path / "out")]) == 0
    assert marks.read_text().split() == ["0", "1", "2"]
    assert "FAILED" not in capsys.readouterr().err


def test_the_suite_times_out_an_entry(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(suite, "commands", lambda out: [
        ["python", "-c", "import time; time.sleep(30)"]])
    monkeypatch.setattr(suite, "TIMEOUT_S", 1)
    assert suite.main(["--out", str(tmp_path / "out")]) == 1
    assert "FAILED entry 0 (rc 124)" in capsys.readouterr().err


def test_the_suite_refuses_the_root_and_lists_its_entries(capsys):
    with pytest.raises(SystemExit, match="repository root"):
        suite.main(["--out", str(ROOT)])
    assert suite.main(["--list"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert len(listed) == len(suite.commands(report.RECORD_DIR)) == 21
    assert listed[20].split()[1:] == suite.commands(report.RECORD_DIR)[20]


@pytest.fixture
def autotune_scratch(tmp_path, monkeypatch):
    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("CESCOIN_AUTOTUNE_LOG_HITS", "")
    yield
    autotune.clear()


def test_the_port_rows_render(tmp_path, autotune_scratch):
    """One ``--per-layer --smoke`` and one ``--batch-curve`` CPU run of the
    bench into one record: refused as "cpu"; labelled as a card, every row
    and headline in its table under the card's heading."""
    cpu = tmp_path / "cpu" / report.SWEEP
    cpu.parent.mkdir()
    lines = []
    for argv in (["--per-layer", "--smoke", "--batch", "1"],
                 ["--batch-curve", "--model", "lenet"]):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            assert bench.main(argv + ["--repeats", "1", "--platform", "cpu",
                                      "--jsonl", str(cpu)]) == 0
        lines.append(json.loads(out.getvalue().splitlines()[-1]))
    with pytest.raises(report.RefusedRow, match=f"{cpu}:1"):
        report.load(cpu)
    card = tmp_path / "card"
    card.mkdir()
    rows = [dict(json.loads(r), device=CARD)
            for r in cpu.read_text().splitlines()]
    (card / report.SWEEP).write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    assert report.main(["--dir", str(card), "--write"]) == 0
    text = (card / report.TABLES).read_text()
    titles = [t for t in text.splitlines() if t.startswith("## ")]
    assert titles and all(t.endswith(report.HEADING_SEP + CARD)
                          for t in titles)
    per_layer, curve = lines
    assert (f"| {per_layer['metric']} | 1 | {per_layer['value']}x | "
            f"{per_layer['speedup_vs_dense_f32']}x | "
            f"{per_layer['gnnz_per_s']} |") in text
    layer_rows = [r for r in rows if "cin" in r]
    assert layer_rows
    for r in layer_rows:
        assert (f"| {r['h']}x{r['w']} {r['cin']}->{r['cout']} k{r['k']} | "
                f"{r['count']} | {r['t_dense_bf16_us']} | "
                f"{r['t_sparse_us']} |") in text
    for batch, ips in curve["rows"]:
        assert f"| lenet | {batch} | " in text and f" | {ips} |" in text
    assert f"Peak {curve['value']} img/s." in text


def test_the_committed_capture_renders_to_the_committed_tables():
    sweep = report.load(report.RECORD_DIR / report.SWEEP)
    scaling = report.load(report.RECORD_DIR / report.SCALING)
    # a headline from each of the suite's 18 bench entries that append one
    # (the batch curve appends its rows alone), the halo rows beside
    assert sum("metric" in r for r in sweep) >= 18
    assert any(r.get("kind") == "batch_curve" for r in sweep)
    assert any(r.get("metric") == "halo_overhead_1dev" for r in scaling)
    rows = sweep + scaling
    assert all(re.fullmatch(r"NVIDIA .+, \d+\.\d+ W", r["device"])
               for r in rows)
    # from another directory: the record is found at the repository root
    proc = subprocess.run(
        [sys.executable, "-m", "caffe_escoin_tpu_torch.tools.report"],
        cwd=ROOT / "docs", capture_output=True, timeout=120, check=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.stdout == (report.RECORD_DIR / report.TABLES).read_bytes()
