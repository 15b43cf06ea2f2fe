"""The work a forward needs, counted from the configuration's shapes and
the pruned weights the benchmark made, whatever implements it.

* live FLOPs of a conv or fc = 2 x output positions x nonzero weights;
* its bytes: the bfloat16 input read once, the live weights read once, the
  residual read once where the layer adds one, the output written once;
* its bound: the larger of FLOPs / peak FLOP/s and bytes / peak byte/s,
  from the published peaks in ``peaks/<card>.json`` for the card's name
  (each character of the name outside letters, digits, ``_``, ``.`` and
  ``-`` read as ``_``).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional

from portbench.reference import plain

BYTES = 2  # bfloat16 activations and weights
PEAKS_DIR = Path(__file__).resolve().parent / "peaks"


def layer_work(kind: str, in_shape, out_shape, nnz: int,
               residual: bool) -> Dict[str, float]:
    """FLOPs and bytes of one conv (NHWC shapes) or fc ([N, K] -> [N, M])."""
    positions = 1
    for d in out_shape[:-1]:
        positions *= d
    n_in = 1
    for d in in_shape:
        n_in *= d
    n_out = positions * out_shape[-1]
    flops = 2 * positions * nnz
    moved = n_in + nnz + n_out + (n_out if residual else 0)
    return {"flops": float(flops), "bytes": float(moved * BYTES)}


def net_work(table, params, batch: int, hwc) -> Dict[str, Dict[str, float]]:
    """name -> {"flops", "bytes"} of every conv and fc at ``batch``."""
    shapes = plain.shapes(table, (batch,) + tuple(hwc))
    out = {}
    for e in table:
        if e["type"] not in ("conv", "fc"):
            continue
        nnz = int((params[e["name"]]["w"] != 0).sum())
        in_shape = shapes[e["bottom"]]
        if e["type"] == "fc":
            k = 1
            for d in in_shape[1:]:
                k *= d
            in_shape = (in_shape[0], k)
        out[e["name"]] = layer_work(e["type"], in_shape, shapes[e["top"]],
                                    nnz, bool(e.get("residual")))
    return out


def peaks(device_kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of a card by its name, or None for a card the
    table does not hold (no share is then reported)."""
    path = PEAKS_DIR / (re.sub(r"[^A-Za-z0-9_.-]", "_", device_kind)
                        + ".json")
    if not path.is_file():
        return None
    with open(path) as f:
        peak = json.load(f)
    return {k: float(peak[k]) for k in ("bf16_flop_s", "hbm_byte_s")}


def bound_s(work: Dict[str, float], peak: Dict[str, float]) -> float:
    return max(work["flops"] / peak["bf16_flop_s"],
               work["bytes"] / peak["hbm_byte_s"])
