"""Render the sweep table of the port's headline rows (port of
``scripts/sweep_table.py``): every row of ``docs/cuda/BENCH_SWEEP.jsonl``
(or the file given) that has a ``metric``, in capture order, one table per
card under a ``### <device label>`` line. A row without a card's device
label is refused, as ``tools/report.load`` refuses it; the JAX package's
``BENCH_SWEEP.jsonl`` raises.

    python -m caffe_escoin_tpu_torch.tools.sweep_table [FILE]
"""

from __future__ import annotations

import sys

from caffe_escoin_tpu_torch.tools import report


def table(rows):
    """``scripts/sweep_table.py``'s table of the rows with a ``metric``."""
    lines = ["| metric | batch | vs dense-bf16 | vs dense-f32 | notes |",
             "|---|---|---|---|---|"]
    for r in rows:
        if "metric" not in r:
            continue
        notes = []
        if "gnnz_per_s" in r:
            notes.append(f"{r['gnnz_per_s']/1000:.1f} Tnnz/s")
        if "t_sparse_ms" in r:
            notes.append(f"sparse {r['t_sparse_ms']}ms "
                         f"bf16 {r['t_dense_bf16_ms']}ms")
        vs_f32 = r.get("speedup_vs_dense_f32", "")
        lines.append(f"| {r['metric']} | {r.get('batch','')} | "
                     f"{r.get('value','')}x | "
                     f"{vs_f32}{'x' if vs_f32 != '' else ''} | "
                     f"{', '.join(notes)} |")
    return lines


def lines_per_device(rows):
    out = []
    for dev, rs in report.by_device(rows).items():
        out += ([""] if out else []) + [f"### {dev}", ""] + table(rs)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else report.RECORD_DIR / report.SWEEP
    for line in lines_per_device(report.load(path)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
