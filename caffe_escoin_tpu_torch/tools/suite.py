"""The measurement suite on the card (port of ``scripts/run_chip_suite.sh``,
with the two captures of ``scripts/run_chip_r5i.sh`` that fed the
reference's tables): ``python -m caffe_escoin_tpu_torch.bench`` over
models, sparsities, batches and modes, each row appended to the capture's
record, then ``python -m caffe_escoin_tpu_torch.tools.report --write``
renders it.

    python -m caffe_escoin_tpu_torch.tools.suite            # into docs/cuda
    python -m caffe_escoin_tpu_torch.tools.suite --list     # the entries
    python -m caffe_escoin_tpu_torch.tools.suite --out DIR  # elsewhere

The entries run in the reference's order, the critical measurements first,
so that a cut run still holds what matters: each bench entry appends its
rows and headline to ``<out>/BENCH_SWEEP.jsonl``, ``--halo`` to
``<out>/SCALING.jsonl``. Each runs as its own process from the repository
root, under its own 3600 s timeout, with the caller's environment
(``CUDA_VISIBLE_DEVICES`` included); after a failed entry the suite goes on
to the next, as the shell script did, and then exits 1 naming every entry
that failed. The first kernel launch builds the kernels into ``build/``,
which every later entry loads (each entry's log line says whether it built
or reused the library). The autotune table is the bench's own default,
``.autotune_cuda.json`` (gitignored), where the shell script set
``CESCOIN_AUTOTUNE_CACHE=.autotune_tpu.json``; the card-test lane is
``pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the card's machine
has no jax, which ``tests/conftest.py`` imports) where it was ``-m tpu``.
``--out`` refuses the repository root, where the JAX package's records are.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

from caffe_escoin_tpu_torch.tools import report

TIMEOUT_S = 3600
BENCH = ["python", "-m", "caffe_escoin_tpu_torch.bench"]
CARD_TESTS = ["python", "-m", "pytest", "--noconftest", "-m", "cuda",
              "tests/test_torch_cuda.py", "-q"]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def commands(out_dir):
    """The suite's entries, each an argv, in the reference's order."""
    sweep = str(Path(out_dir) / report.SWEEP)

    def bench(*argv, jsonl=sweep):
        return BENCH + list(argv) + ["--jsonl", jsonl]

    return [
        # run_chip_suite.sh, 1: the whole-net e2e with buckets (the
        # headline) at batch 32, and at batch 8
        bench("--e2e", "--buckets", "--batch", "32", "--repeats", "8"),
        bench("--e2e", "--batch", "8", "--repeats", "8"),
        # 2: unstructured element pruning (no mode flag: a bare run, the
        # e2e at batch 32 with buckets, calibrated, as in bench.py)
        bench("--granularity", "unstructured", "--sparsity", "0.9",
              "--layers", "6"),
        # 3: the fc bucket (VGG-16 fc6/fc7)
        bench("--fc", "--model", "vgg16", "--batch", "32", "--sparsity",
              "0.9"),
        # 4: more e2e models
        bench("--e2e", "--model", "alexnet", "--batch", "16", "--repeats",
              "8"),
        bench("--e2e", "--model", "googlenet", "--batch", "16", "--repeats",
              "8"),
        bench("--e2e", "--model", "vgg16", "--batch", "8", "--repeats", "6"),
        # 5: the card-test lane
        list(CARD_TESTS),
        # 6: the sweep over sparsities and models (bare runs too)
        *[bench("--sparsity", s) for s in ("0.9", "0.7", "0.8", "0.95")],
        *[bench("--model", "alexnet", "--sparsity", s)
          for s in ("0.7", "0.9")],
        bench("--model", "googlenet", "--sparsity", "0.9"),
        bench("--model", "vgg16", "--sparsity", "0.9"),
        # 7: the single-card batch curve
        bench("--batch-curve", "--repeats", "8"),
        # run_chip_r5i.sh: the calibrated ResNet-50 b32 e2e at 70/80/95%,
        # and the halo path's overhead
        *[bench("--e2e", "--model", "resnet50", "--batch", "32", "--sparsity",
                s, "--calibrate", "--calibrate-polish", "6")
          for s in ("0.7", "0.8", "0.95")],
        bench("--halo", jsonl=str(Path(out_dir) / report.SCALING)),
    ]


def _library_state():
    """(path, mtime or None) of the kernel library this tree builds."""
    from caffe_escoin_tpu_torch.kernels import _build

    lib = _build.library_path()
    return lib, (lib.stat().st_mtime if lib.exists() else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m caffe_escoin_tpu_torch.tools.suite",
        description="The port's measurement suite on the card (the port of "
                    "scripts/run_chip_suite.sh); see the module docstring.")
    ap.add_argument("--out", default=str(report.RECORD_DIR),
                    help="the capture's directory (default docs/cuda)")
    ap.add_argument("--list", action="store_true",
                    help="print the numbered entries and exit")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if out == report.ROOT:
        raise SystemExit("--out: the repository root holds the JAX "
                         "package's records; use docs/cuda or another "
                         "directory")
    cmds = commands(out)
    if args.list:
        for i, cmd in enumerate(cmds):
            print(f"{i:2d} {' '.join(cmd)}")
        return 0
    out.mkdir(parents=True, exist_ok=True)
    failed = []
    t_suite = time.perf_counter()
    for i, cmd in enumerate(cmds):
        log(f"=== {' '.join(cmd)} ===")
        lib, before = _library_state()
        t0 = time.perf_counter()
        try:
            rc = subprocess.run(
                [sys.executable if a == "python" else a for a in cmd],
                cwd=report.ROOT, timeout=TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = 124
        _, after = _library_state()
        built = ("no library" if after is None else "reused" if after == before
                 else "built" if before is None else "REBUILT")
        log(f"=== entry {i}: rc {rc}, {time.perf_counter() - t0:.1f} s, "
            f"{lib.name}: {built} ===")
        if rc:
            failed.append((i, rc, cmd))
    log(f"=== suite: {len(cmds) - len(failed)} of {len(cmds)} entries "
        f"passed in {time.perf_counter() - t_suite:.1f} s ===")
    for i, rc, cmd in failed:
        log(f"FAILED entry {i} (rc {rc}): {' '.join(cmd)}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
