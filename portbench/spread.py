"""Repeated runs of one cell and the spread of each metric, from which a
bound is set:

    python3 -m portbench.spread --workload <cell> --runs 6 --sets 2 \
        [--seconds S] [--seed-base N] [--trace 0|1]

``--seconds`` defaults to ``run_seconds`` of ``BENCHMARK.json``. Each run
is its own process (``portbench/run.py``), as the checks run it;
every set uses the same seeds, ``seed-base`` to ``seed-base + runs - 1``.
For each set and metric: the median and the spread, the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``) as
a share of the median. The summary gives, per metric, the wider of the
sets' spreads and five times it, and ``setup_s``'s medians per set. One
JSON line per run, then the summary; each run's standard error goes to
``--log-dir``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("inf")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=int, default=json.loads(
        (ROOT / "BENCHMARK.json").read_text())["run_seconds"])
    ap.add_argument("--seed-base", type=int, default=3_100_000_000)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--log-dir", default="build/spread")
    args = ap.parse_args(argv)
    logs = Path(args.log_dir)
    logs.mkdir(parents=True, exist_ok=True)
    sets = []
    for s in range(args.sets):
        rows = []
        for i in range(args.runs):
            seed = args.seed_base + i
            err = logs / f"{args.workload}.set{s}.{seed}.t{args.trace}.err"
            with open(err, "w") as ferr:
                proc = subprocess.run(
                    [sys.executable, str(ROOT / "portbench" / "run.py"),
                     "--workload", args.workload, "--seed", str(seed),
                     "--seconds", str(args.seconds), "--trace",
                     str(args.trace)],
                    cwd=ROOT, stdout=subprocess.PIPE, stderr=ferr, text=True,
                    timeout=1500)
            lines = proc.stdout.strip().splitlines()
            result = json.loads(lines[-1]) if proc.returncode == 0 and lines \
                else None
            row = {"set": s, "seed": seed, "rc": proc.returncode,
                   "correct": result and result["correct"],
                   "metrics": {k: v["value"] for k, v in
                               (result or {}).get("metrics", {}).items()},
                   "checks": (result or {}).get("checks"),
                   "device": (result or {}).get("device")}
            if result and "breakdown" in result:
                row["breakdown"] = result["breakdown"]
            print(json.dumps(row), flush=True)
            rows.append(row)
        sets.append(rows)
    summary = {"workload": args.workload, "runs": args.runs,
               "seconds": args.seconds, "metrics": {}}
    names = sorted({k for rows in sets for r in rows for k in r["metrics"]})
    for name in names:
        per_set = []
        for rows in sets:
            vals = [r["metrics"][name] for r in rows if name in r["metrics"]]
            if len(vals) >= 2:
                per_set.append({"median": statistics.median(vals),
                                "spread": spread(vals)})
        if per_set:
            widest = max(p["spread"] for p in per_set)
            summary["metrics"][name] = {"sets": per_set, "widest": widest,
                                        "five_times": 5 * widest}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
