"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout. Set-up,
warm-up, the measured window, then the check; the last line of standard
output is the result object, everything else goes to standard error.
Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# run as a script, the interpreter puts portbench/ first on the path, where
# its module names could shadow others: the checkout's root goes there
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402
# the program's build and kernel caches: fixed directories in the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    torch_imported = time.perf_counter()
    from portbench import harness

    imports = harness.process_age()
    marks = {"torch": imports - (time.perf_counter() - torch_imported),
             "imports": imports}
    bench = harness.Bench(ROOT)
    try:
        cell = bench.cell(args.workload)
    except KeyError as e:
        harness.log(str(e))
        return 2
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"{args.workload} needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} found")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    marks["card"] = harness.process_age()
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device, marks=marks)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
