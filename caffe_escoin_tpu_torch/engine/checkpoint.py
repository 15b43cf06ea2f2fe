"""Snapshot / restore (port of ``caffe_escoin_tpu/engine/checkpoint.py``).

Reference: `Solver::Snapshot/Restore` writes `.caffemodel` (weights) +
`.solverstate` (iter, momentum history) (`src/caffe/solver.cpp:403-472`,
`sgd_solver.cpp:246-302`). Here both are one `.npz` of the flattened nested
dicts (keys ``params/<layer>/<name>``, ``state/...``, ``net_state/...``)
plus a JSON sidecar of metadata: the JAX package's layout, so a checkpoint
written by either package loads in the other. Leaves are written as numpy
arrays (from tensors on any device) and read back as CPU tensors.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(val)
    return root


def save_checkpoint(path: str, params, *, solver_state=None, net_state=None,
                    meta=None):
    """Writes path.npz (+ path.json). Only plain nested dicts of tensors
    (train-side params; an aligned sparse weight is rebuilt by
    ``weight_align`` after a load, as the reference realigns in
    CopyTrainedLayersFrom). ``net_state`` holds the non-trainable buffers
    (BatchNorm moving stats, which the reference keeps as ordinary layer
    blobs in the .caffemodel)."""
    flat = _flatten({"params": params})
    if solver_state is not None:
        flat.update(_flatten({"state": solver_state}))
    if net_state:
        flat.update(_flatten({"net_state": net_state}))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **flat)
    with open(path + ".json", "w") as f:
        json.dump(meta or {}, f)


def load_checkpoint(path: str) -> Tuple[Any, Any, Dict]:
    """Returns (params, solver_state_or_None, meta); the buffer state is
    read by ``load_checkpoint_full``."""
    params, state, _net_state, meta = load_checkpoint_full(path)
    return params, state, meta


def load_checkpoint_full(path: str) -> Tuple[Any, Any, Any, Dict]:
    """Returns (params, solver_state_or_None, net_state_or_None, meta)."""
    with np.load(path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return (tree.get("params", {}), tree.get("state"), tree.get("net_state"),
            meta)
