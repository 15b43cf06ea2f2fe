"""Net-definition serialization to versioned JSON (port of
``caffe_escoin_tpu/nn/serialize.py``; a copy, the same format, so either
package reads the other's files).

Reference: Caffe's NetParameter prototxt (`src/caffe/proto/caffe.proto`) with
the legacy migration pass (`src/caffe/util/upgrade_proto.cpp`, 1106 LoC).
`UPGRADERS` provides the same load-time migration hook so old files keep
working as the format evolves.

Round-trip contract: specs == from_json(to_json(specs)) for all layer types
whose params are JSON-representable (arrays are converted to nested lists).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

from caffe_escoin_tpu_torch.nn.net import LayerSpec

FORMAT_VERSION = 1

# version -> migration fn(dict) -> dict (applied in sequence on load)
UPGRADERS: Dict[int, Callable[[dict], dict]] = {}


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def _unjsonable(v):
    if isinstance(v, dict):
        if "__ndarray__" in v:
            return np.asarray(v["__ndarray__"], dtype=v["dtype"])
        return {k: _unjsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unjsonable(x) for x in v]
    return v


def specs_to_json(specs: Sequence[LayerSpec], *, name: str = "net") -> str:
    layers = []
    for s in specs:
        d = {
            "name": s.name,
            "type": s.type,
            "bottoms": list(s.bottoms),
            "tops": list(s.tops),
            "params": _jsonable(s.params),
        }
        if s.phase is not None:
            d["phase"] = s.phase
        if s.loss_weight:
            d["loss_weight"] = s.loss_weight
        if s.share_params:
            d["share_params"] = s.share_params
        layers.append(d)
    return json.dumps(
        {"format_version": FORMAT_VERSION, "name": name, "layers": layers},
        indent=2,
    )


def specs_from_json(text: str) -> List[LayerSpec]:
    doc = json.loads(text)
    version = doc.get("format_version", 0)
    for v in range(version, FORMAT_VERSION):
        if v in UPGRADERS:
            doc = UPGRADERS[v](doc)
    specs = []
    for d in doc["layers"]:
        specs.append(
            LayerSpec(
                name=d["name"],
                type=d["type"],
                bottoms=tuple(d.get("bottoms", ())),
                tops=tuple(d.get("tops", ())),
                params=_unjsonable(d.get("params", {})),
                phase=d.get("phase"),
                loss_weight=d.get("loss_weight", 0.0),
                share_params=d.get("share_params"),
            )
        )
    return specs


def save_net(path: str, specs: Sequence[LayerSpec], *, name: str = "net"):
    with open(path, "w") as f:
        f.write(specs_to_json(specs, name=name))


def load_net(path: str) -> List[LayerSpec]:
    with open(path) as f:
        return specs_from_json(f.read())
