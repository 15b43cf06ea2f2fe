"""The readings a check's limit is set from, on the card:

    python3 -m portbench.control --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 2 [--witness]

For each of ``--seeds`` seeds, one run of the cell with the program
(short window, untraced): its ``logit_rel_err`` is a lower reading. For
each of ``--control-seeds`` seeds, the same run with the control in the
program's place, the plain reference computed in float8 (e4m3, the
nearest precision below the configuration's bfloat16): its number is an
upper reading. ``--witness`` adds the reference in bfloat16, a second
witness of what bfloat16 alone costs. All in one process: the set-up of
each seed is paid once. One JSON line per run on standard output, then a
summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEED_BASE = 2_000_000_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seed-base", type=int, default=SEED_BASE)
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.system import ReferenceSystem

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    bench = harness.Bench(ROOT)

    def reference_at(precision):
        return lambda cfg, table, params, dev: ReferenceSystem(
            cfg, table, params, dev, precision)

    sides = [("program", None, args.seeds),
             ("control", reference_at("float8_e4m3fn"), args.control_seeds)]
    if args.witness:
        sides.append(("witness", reference_at("bfloat16"),
                      args.control_seeds))
    readings = {}
    for side, make, n in sides:
        for i in range(n):
            seed = args.seed_base + i
            r = harness.run_cell(bench, args.workload, seed, args.seconds,
                                 False, device, make_system=make,
                                 clock=lambda: 0.0)
            value = r["checks"]["logit_rel_err"]["value"]
            readings.setdefault(side, []).append(value)
            print(json.dumps({"workload": args.workload, "side": side,
                              "seed": seed, "logit_rel_err": value,
                              "attempted": r["attempted"],
                              "device": r["device"]["kind"]}), flush=True)
    summary = {"workload": args.workload,
               "lower": max(readings["program"]),
               "upper": min(readings["control"])}
    if "witness" in readings:
        summary["witness_max"] = max(readings["witness"])
    summary["ratio"] = summary["upper"] / summary["lower"]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
