"""Generate docs/cuda/BENCH_TABLES.md from the port's captured records (port
of ``scripts/report.py``).

Single source of truth: ``docs/cuda/BENCH_SWEEP.jsonl`` (the rows and
headlines of ``python -m caffe_escoin_tpu_torch.bench``) and
``docs/cuda/SCALING.jsonl`` (its ``--halo`` rows), both captured on the card
by ``python -m caffe_escoin_tpu_torch.tools.suite``. Generating the tables
from the rows means no table can cite a capture that never ran.

Usage:
  python -m caffe_escoin_tpu_torch.tools.report          # print markdown
  python -m caffe_escoin_tpu_torch.tools.report --write  # rewrite the
      # tables, docs/cuda/BENCH_TABLES.md
  python -m caffe_escoin_tpu_torch.tools.report --dir DIR [--write]
      # another capture (the suite's --out DIR): DIR/BENCH_SWEEP.jsonl +
      # DIR/SCALING.jsonl, written to DIR/BENCH_TABLES.md

The same tables as ``scripts/report.py``: sections, columns, sort orders,
best-of-sessions grouping, later captures superseding earlier ones. Where
it differs:

* Two captures may come from two cards, so each section is rendered once
  per device label (the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` gives them, which
  the bench writes into every row), in the order the labels first appear,
  and each ``## `` title ends with `` — <label>``.
* A row whose ``device`` is missing or ``"cpu"`` is refused
  (``RefusedRow``, naming the file and line); it is never rendered.
* The inputs default to ``docs/cuda/`` at the repository root, not to the
  working directory. The JAX package's records (``BENCH_SWEEP.jsonl`` and
  ``SCALING.jsonl`` at the root) and its ``docs/BENCH_TABLES.md`` raise as
  input or output.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RECORD_DIR = ROOT / "docs" / "cuda"
SWEEP, SCALING = "BENCH_SWEEP.jsonl", "SCALING.jsonl"
TABLES = "BENCH_TABLES.md"
# the JAX package's records and tables: never read or written here
JAX_FILES = (ROOT / SWEEP, ROOT / SCALING, ROOT / "docs" / TABLES)
HEADING_SEP = " — "


class RefusedRow(ValueError):
    """A row that is not a card's measurement."""


def _guard(path) -> Path:
    p = Path(path).resolve()
    if p in JAX_FILES:
        raise ValueError(f"{p} is the JAX package's record: the port reads "
                         f"and writes docs/cuda/ (or --dir) only")
    return p


def card_label(row, where) -> str:
    """The row's device label; ``RefusedRow`` (naming ``where``) when it
    has none or it is "cpu"."""
    dev = row.get("device")
    if not dev or dev == "cpu":
        raise RefusedRow(f"{where}: device {dev!r}: not a card's "
                         f"measurement, refused")
    return dev


def load(path):
    """The rows of a JSONL record (none if it does not exist); a row
    without a card's device label raises ``RefusedRow``."""
    path = _guard(path)
    rows = []
    try:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                line = line.strip()
                if line:
                    row = json.loads(line)
                    card_label(row, f"{path}:{i}")
                    rows.append(row)
    except FileNotFoundError:
        pass
    return rows


def latest(rows, key):
    """Keep the LAST captured row per key (later rows supersede)."""
    out = {}
    for r in rows:
        out[key(r)] = r
    return list(out.values())


def by_device(rows):
    """{device label: its rows}, the labels in the order they first
    appear."""
    groups = {}
    for r in rows:
        groups.setdefault(card_label(r, f"row {r}"), []).append(r)
    return groups


def _per_device(table):
    """``table`` rendered once per device label, its ``## `` titles ending
    with the label, a blank line between two devices' blocks."""
    @functools.wraps(table)
    def each(rows):
        out = []
        for dev, rs in by_device(rows).items():
            block = [line + HEADING_SEP + dev if line.startswith("## ")
                     else line for line in table(rs)]
            if out and block and block[0]:
                out.append("")
            out += block
        return out

    return each


@_per_device
def headline_table(rows):
    ms = [r for r in rows if "metric" in r and "e2e" in r.get("metric", "")
          and "unit" in r]
    keyf = lambda r: (r["metric"], r.get("batch"),  # noqa: E731
                      r.get("autotune"), r.get("calibrated"),
                      r.get("xbsp_arm"), r.get("fused"), r.get("packed"))
    # composed sparse times vary between sessions: where a configuration
    # has several captures, the table reports the BEST with the count and
    # range, instead of whichever session ran last
    groups = {}
    for r in ms:
        groups.setdefault(keyf(r), []).append(r)
    ms = []
    for g in groups.values():
        best = min(g, key=lambda r: r.get("t_sparse_ms", 1e9))
        if len(g) > 1:
            ts = sorted(r.get("t_sparse_ms", 0) for r in g)
            best = dict(best, _sessions=len(g), _ts_range=(ts[0], ts[-1]))
        ms.append(best)
    lines = [
        "## Whole-net e2e (fused + autotuned unless noted)", "",
        "| model / metric | batch | vs bf16 | vs f32 | sparse ms | "
        "bf16 ms | notes |", "|---|---|---|---|---|---|---|"]
    for r in sorted(ms, key=lambda r: (r["metric"], r.get("batch") or 0)):
        notes = []
        if r.get("xbsp_arm"):
            notes.append(f"forced arm={r['xbsp_arm']} (diagnostic)")
        if not r.get("autotune", True):
            notes.append("no-autotune (heuristic arms)")
        if r.get("calibrated"):
            c = r.get("calibration", {})
            kept = c.get("flips")
            notes.append(
                "graph-calibrated"
                + (f" ({kept}/{c.get('sparse_keys')} sparse keys kept)"
                   if kept is not None else ""))
        if not r.get("fused", True):
            notes.append("unfused graph")
        if r.get("_sessions"):
            lo, hi = r["_ts_range"]
            notes.append(f"best of {r['_sessions']} sessions "
                         f"(sparse {lo}-{hi} ms)")
        lines.append(
            f"| {r['metric']} | {r.get('batch', '')} | {r['value']}x | "
            f"{r.get('speedup_vs_dense_f32', '')}x | "
            f"{r.get('t_sparse_ms', '')} | {r.get('t_dense_bf16_ms', '')} | "
            f"{'; '.join(notes)} |")
    return lines


@_per_device
def conv_bucket_table(rows):
    ms = [r for r in rows if "metric" in r
          and "sparse_conv_speedup" in r.get("metric", "")]
    ms = latest(ms, lambda r: (r["metric"], r.get("batch"),
                               r.get("autotune")))
    lines = ["## Conv-bucket (FLOP-weighted per-layer total)", "",
             "| metric | batch | vs bf16 | vs f32 | Gnnz/s |",
             "|---|---|---|---|---|"]
    for r in sorted(ms, key=lambda r: r["metric"]):
        lines.append(
            f"| {r['metric']} | {r.get('batch', '')} | {r['value']}x | "
            f"{r.get('speedup_vs_dense_f32', '')}x | "
            f"{r.get('gnnz_per_s', '')} |")
    return lines


@_per_device
def fc_table(rows):
    ms = [r for r in rows if "fc_speedup" in str(r.get("metric", ""))]
    if not ms:
        return []
    lines = ["## FC bucket", "",
             "| metric | batch | vs bf16 | vs f32 |", "|---|---|---|---|"]
    for r in latest(ms, lambda r: (r["metric"], r.get("batch"))):
        lines.append(f"| {r['metric']} | {r.get('batch','')} | "
                     f"{r['value']}x | "
                     f"{r.get('speedup_vs_dense_f32', '')}x |")
    return lines


@_per_device
def per_layer_tables(rows):
    pls = [r for r in rows if r.get("h") is not None and "cin" in r]
    groups = {}
    for r in pls:
        # the port's rows have no variant (one NHWC layout): None groups
        # them as the reference's rows without one
        groups.setdefault(
            (r.get("model"), r.get("sparsity"), r.get("granularity"),
             r.get("xbsp_arm"), r.get("variant")), []).append(r)
    lines = []
    for (model, sp, gran, arm, variant), rs in sorted(
            groups.items(), key=lambda kv: (str(kv[0][0]), str(kv[0][1]),
                                            str(kv[0][3]))):
        rs = latest(rs, lambda r: (r["h"], r["w"], r["cin"], r["cout"],
                                   r.get("k"), r.get("batch")))
        tag = ""
        if arm:
            tag += f", forced arm={arm}"
        if variant:
            tag += f", variant={variant}"
        lines += ["", f"## Per-layer: {model} @ {sp:.0%} {gran}{tag} "
                      f"(batch {rs[0].get('batch', '?')})", "",
                  "| shape | n | bf16 us | sparse us | vs bf16 | "
                  "bound us | x of SoL |", "|---|---|---|---|---|---|---|"]
        for r in sorted(rs, key=lambda r: -(r["t_sparse_us"]
                                            * r.get("count", 1))):
            lines.append(
                f"| {r['h']}x{r['w']} {r['cin']}->{r['cout']} "
                f"k{r.get('k','?')} | {r.get('count', 1)} | "
                f"{r['t_dense_bf16_us']} | {r['t_sparse_us']} | "
                f"{r.get('speedup_vs_bf16', '')}x | {r.get('bound_us', '')} "
                f"| {r.get('x_of_bound', '')} |")
    return lines


@_per_device
def batch_curve(rows):
    ms = [r for r in rows if r.get("kind") == "batch_curve"]
    if not ms:
        return []
    ms = latest(ms, lambda r: (r.get("model"), r["batch"]))
    lines = ["## Single-chip batch saturation (fused sparse net)",
             "", "| model | batch | ms | images/s |", "|---|---|---|---|"]
    peak = 0.0
    for r in sorted(ms, key=lambda r: (str(r.get("model")), r["batch"])):
        peak = max(peak, r["images_per_s"])
        lines.append(f"| {r.get('model','?')} | {r['batch']} | "
                     f"{r['t_ms']} | {r['images_per_s']} |")
    lines += ["", f"Peak {peak} img/s."]
    return lines


@_per_device
def halo_table(scaling_rows):
    hs = [r for r in scaling_rows
          if r.get("metric") == "halo_overhead_1dev"]
    if not hs:
        return []
    hs = latest(hs, lambda r: (r["h"], r["cin"], r["cout"],
                               r.get("backend")))
    lines = ["## Halo path overhead on ONE device (shard_map edge cost)",
             "",
             "| shape | backend | plain us | halo us | overhead |",
             "|---|---|---|---|---|"]
    for r in hs:
        lines.append(
            f"| {r['h']}x{r['w']} {r['cin']}->{r['cout']} | "
            f"{r.get('backend','?')} | {r['t_plain_us']} | "
            f"{r['t_halo_us']} | {r['overhead']*100:+.1f}% |")
    return lines


def _rel(path: Path) -> str:
    try:
        return str(path.relative_to(ROOT))
    except ValueError:
        return str(path)


def render(sweep, scaling, record_dir=RECORD_DIR) -> str:
    """The markdown of every table, from the rows of ``record_dir``."""
    src = _rel(Path(record_dir).resolve())
    out = ["# Captured benchmark tables of the PyTorch/CUDA port",
           "",
           f"Generated by `python -m caffe_escoin_tpu_torch.tools.report "
           f"--write` from {src}/{SWEEP} + {src}/{SCALING} — do not edit "
           f"by hand. Each section is rendered per card, named with its "
           f"power limit as nvidia-smi gives them. Later captures "
           f"supersede earlier ones per configuration; the raw files keep "
           f"the full history (including superseded and diagnostic rows).",
           ""]
    out += headline_table(sweep)
    out += [""] + conv_bucket_table(sweep)
    out += [""] + fc_table(sweep)
    out += [""] + batch_curve(sweep)
    out += [""] + halo_table(scaling)
    out += per_layer_tables(sweep)
    return "\n".join(out) + "\n"


def write(text, path):
    path = _guard(path)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m caffe_escoin_tpu_torch.tools.report",
        description="Render the port's captured bench rows as markdown "
                    "tables (the port of scripts/report.py).")
    ap.add_argument("--write", action="store_true",
                    help=f"rewrite DIR/{TABLES} instead of printing")
    ap.add_argument("--dir", default=str(RECORD_DIR),
                    help=f"the capture's directory, holding {SWEEP} and "
                         f"{SCALING} (default docs/cuda)")
    args = ap.parse_args(argv)
    record_dir = Path(args.dir).resolve()
    text = render(load(record_dir / SWEEP), load(record_dir / SCALING),
                  record_dir)
    if args.write:
        print(f"wrote {_rel(write(text, record_dir / TABLES))}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
