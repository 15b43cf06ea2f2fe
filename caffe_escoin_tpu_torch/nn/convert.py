"""Carry the JAX package's net parameters, BatchNorm state and solver
state over to the port."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def params_from_jax(params: Dict[str, Any],
                    state: Optional[Dict[str, Any]] = None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The JAX ``Net``'s params and BatchNorm state (layer name -> dict of
    arrays, e.g. numpy) as the port's (CPU tensors, names unchanged), so
    both nets built from the same specs compute the same function: the
    layers keep the JAX names and layouts of their params (conv and
    Deconvolution ``w`` [KH, KW, Cin, Cout] and ``b``; the recurrent
    ``wx``, ``wh``, ``b``; Embed's and Parameter's ``w``; ...). Works on
    anything ``np.asarray`` takes, so it needs no jax import."""
    return _to_torch(params), _to_torch(state or {})


def solver_state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX solver state (``{"h"}``, ``{"h", "h2"}`` or ``{"m", "v"}``,
    each a tree like the params) as the port's ``engine.solvers`` state:
    CPU tensors under the same keys."""
    return _to_torch(state)
