"""Run-to-run stability of the same sparse forward (port of
``scripts/exp_stability_r5.py``): ResNet-50 b32 packed and autotuned
(``common.sparse_net``) against the same model dense in bf16, each phase in
a process of its own:

  A: the sparse forward timed 3x from a cold start;
  B: about 60 varied small modules run and captured first (what a fresh
     autotune run does before its whole-net timings), then timed 3x;
  C: the forward rebuilt (weights aligned and moved again) and recaptured,
     2x;
  D: the dense control at the start and the end, the sparse forward once
     between.

Each sparse timing is ``device_time`` over CUDA-graph replays cycling the
4 inputs (``t_sparse_ms``), with a host-clock cross-check beside it:
``--wall-iters`` calls of ``inference_fn(cuda_graph=True)`` between two
synchronizations (``wall_ms``). One ``stability`` row per phase; with more
than one phase (the default: A,B,C,D), this process spawns one process
per phase, in turn, and ends with a ``stability_summary`` row: the spread
(max / min) of every sparse graph time, the dense one's, and whether the
sparse spread exceeds ``BIMODAL``. The autotune table
(``CESCOIN_AUTOTUNE_CACHE``) carries the first phase's measurements to the
next.

    python -m caffe_escoin_tpu_torch.experiments.stability [--phase A,D]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from caffe_escoin_tpu_torch.engine import autotune
from caffe_escoin_tpu_torch.experiments import common
from caffe_escoin_tpu_torch.utils.benchmark import device_time

MODULE = "caffe_escoin_tpu_torch.experiments.stability"
PHASES = ("A", "B", "C", "D")
# a spread of the sparse graph time above this reads as two modes (the JAX
# package's record: 0.923 and 1.287 ms, 1.39x, for one module)
BIMODAL = 1.10


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Probe:
    """One phase's nets and timers."""

    def __init__(self, device, *, model, batch, iters, wall_iters):
        self.device, self.model, self.batch = device, model, batch
        self.iters, self.wall_iters = iters, wall_iters
        self.build()
        self.net_d, self.params_d = common.dense_bf16_net(self.s, device)

    def build(self):
        self.s = common.sparse_net(self.model, self.batch, self.device,
                                   pack=True)

    def _time(self, fn):
        xs = self.s.xs
        return device_time(lambda y: common.first(fn({"data": y})), xs[0],
                           iters=self.iters, arg_sets=[(x,) for x in xs])

    def dense(self) -> float:
        return self._time(self.net_d.inference_fn(self.params_d)) * 1e3

    def sparse(self):
        """(graph ms, wall ms per call of the graph-replay forward)."""
        s = self.s
        with autotune.net_scope(self.model):
            t = self._time(s.net.inference_fn(s.aligned))
            fn = s.net.inference_fn(s.aligned, cuda_graph=True)
            for x in s.xs:
                fn({"data": x})
            _sync(self.device)
            t0 = time.perf_counter()
            for i in range(self.wall_iters):
                fn({"data": s.xs[i % len(s.xs)]})
            _sync(self.device)
            wall = (time.perf_counter() - t0) / self.wall_iters
        return t * 1e3, wall * 1e3


def zoo(device, n: int, seed: int = 1) -> float:
    """``n`` varied small modules (a bf16 product and ReLU at a random map
    and width), each run and captured once; returns the seconds taken."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for _ in range(n):
        hw = int(rng.choice([7, 14, 28, 56]))
        cc = int(rng.choice([64, 128, 256, 512]))
        a = torch.from_numpy(rng.standard_normal((8, hw, hw, cc)).astype(
            np.float32)).to(device, torch.bfloat16)
        w = torch.from_numpy(rng.standard_normal((cc, 128)).astype(
            np.float32)).to(device, torch.bfloat16)
        device_time(lambda u, v: torch.relu(torch.matmul(u, v)), a, w,
                    iters=1)
    return time.perf_counter() - t0


def run_phase(phase, device, emit, *, model="resnet50", batch=32,
              iters=20, wall_iters=200, zoo_modules=60):
    """One phase in this process; returns its row."""
    p = Probe(device, model=model, batch=batch, iters=iters,
              wall_iters=wall_iters)
    row = {"kind": "stability", "phase": phase, "model": model,
           "batch": batch, "packed": bool(getattr(p.s.net, "packed_blobs",
                                                  None))}
    if phase == "D":
        row["t_dense_start_ms"] = round(p.dense(), 4)
    if phase == "B":
        row["zoo_modules"] = zoo_modules
        row["zoo_s"] = round(zoo(device, zoo_modules), 2)
    times = []
    for i in range({"A": 3, "B": 3, "C": 2, "D": 1}[phase]):
        if phase == "C":
            p.build()  # aligned and moved again: new buffers, new capture
        times.append(p.sparse())
    row["t_sparse_ms"] = [round(t, 4) for t, _ in times]
    row["wall_ms"] = [round(w, 4) for _, w in times]
    if phase == "D":
        row["t_dense_end_ms"] = round(p.dense(), 4)
    return emit(**row)


def summary(rows):
    """The spread of the sparse graph times over ``rows`` (and of the
    dense control's, where phase D ran)."""
    sparse = [t for r in rows for t in r["t_sparse_ms"]]
    dense = [r[k] for r in rows for k in ("t_dense_start_ms",
                                          "t_dense_end_ms") if k in r]
    spread = max(sparse) / min(sparse)
    return {"kind": "stability_summary",
            "phases": [r["phase"] for r in rows],
            "sparse_min_ms": min(sparse), "sparse_max_ms": max(sparse),
            "spread": round(spread, 4),
            "dense_spread": (round(max(dense) / min(dense), 4) if dense
                             else None),
            "bimodal": spread > BIMODAL}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = common.parser("stability", __doc__)
    ap.add_argument("--phase", default=",".join(PHASES),
                    help="comma list of A, B, C, D; more than one: one "
                         "process each")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--wall-iters", type=int, default=200)
    ap.add_argument("--zoo", type=int, default=60,
                    help="small modules run before phase B's timings")
    args = ap.parse_args(argv)
    phases = [p for p in args.phase.split(",") if p]
    if not phases or any(p not in PHASES for p in phases):
        ap.error(f"--phase: a comma list of {PHASES}")
    device = common.device_of(args.platform)
    if device is None:
        return 2
    emit = common.Rows(args.out, device)
    with common.env_defaults():
        if len(phases) == 1:
            run_phase(phases[0], device, emit, model=args.model,
                      batch=args.batch, iters=args.iters,
                      wall_iters=args.wall_iters, zoo_modules=args.zoo)
            return 0
        rows = []
        for phase in phases:
            cmd = [sys.executable, "-m", MODULE, *_without_phase(argv),
                   "--phase", phase, "--out", emit.path]
            proc = subprocess.run(cmd, cwd=common.ROOT, env=dict(os.environ),
                                  capture_output=True, text=True)
            sys.stderr.write(proc.stderr)
            if proc.returncode:
                common.log(f"stability: phase {phase} exited "
                           f"{proc.returncode}")
                return proc.returncode
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(row), flush=True)
            rows.append(row)
        emit(**summary(rows))
    return 0


def _without_phase(argv):
    """``argv`` without its --phase and --out flags (the child gets its
    own)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--phase", "--out"):
            skip = True
            continue
        if a.startswith(("--phase=", "--out=")):
            continue
        out.append(a)
    return out


if __name__ == "__main__":
    sys.exit(main())
